"""BENCHMARK.json against the files of the benchmark and the contract's
rules: keys, names, units, bounds, and every name found by a file."""
import json
import math
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
M = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = M["end_to_end"] + M["per_layer"]
CELLS = [w["name"] for w in M["workloads"]]


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["command"] == ["python3", "dme_bench/run.py"]
    assert M["paths"] == ["dme_bench"]
    assert len(json.dumps(M)) < 64 * 1024


def test_run_seconds_fit_a_full_check_of_24_cells():
    s = M["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("c", M["configs"], ids=lambda c: c["name"])
def test_config(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(c["name"]) and c["source"].startswith("https://")
    assert c["file"] == f"dme_bench/configs/{c['name']}.json"
    cfg = json.loads((ROOT / c["file"]).read_text())
    assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
    assert c["reduced"] == [] and any(w["config"] == c["name"]
                                      for w in M["workloads"])
    con = cfg["contract"]
    assert cfg["padded"] == math.ceil(cfg["d"] / con["bucket"]) * con["bucket"]
    assert set(cfg["assumed"]) <= set(con)


def whisper_params(c):
    """Trainable parameters of transformers' Whisper at config ``c``: the
    conv front end, the learned decoder positions (the encoder's sinusoids
    are fixed), biases on q, v and out but not k, LayerNorms with biases,
    the output projection tied to the token embedding."""
    D = c["d_model"]
    attn = 4 * D * D + 3 * D
    ln = 2 * D

    def ffn(f):
        return 2 * D * f + f + D

    front = c["num_mel_bins"] * D * 3 + D + D * D * 3 + D
    enc = front + c["encoder_layers"] * (
        attn + ffn(c["encoder_ffn_dim"]) + 2 * ln) + ln
    dec = (c["vocab_size"] + c["max_target_positions"]) * D + c[
        "decoder_layers"] * (2 * attn + ffn(c["decoder_ffn_dim"]) + 3 * ln) + ln
    head = 0 if c["tie_word_embeddings"] else c["vocab_size"] * D
    return enc + dec + head


def granitemoe_params(c):
    """Parameters of transformers' GraniteMoe at config ``c``: attention
    without biases, every expert's input (gate and up) and output linears,
    the router, two RMS norms a layer, the head tied to the embedding."""
    H, L, E = c["hidden_size"], c["num_hidden_layers"], c["num_local_experts"]
    hd = H // c["num_attention_heads"]
    assert not c["attention_bias"]
    attn = 2 * H * H + 2 * H * c["num_key_value_heads"] * hd
    moe = E * 3 * H * c["intermediate_size"] + H * E
    head = 0 if c["tie_word_embeddings"] else c["vocab_size"] * H
    return c["vocab_size"] * H + L * (attn + moe + 2 * H) + H + head


PARAMS = {"whisper": whisper_params, "granitemoe": granitemoe_params}


@pytest.mark.parametrize("name", [c["name"] for c in M["configs"]])
def test_config_width_is_the_models_gradient(name):
    """d is the sum of the listed trainable tensors, and so the published
    config's count by an independent formula."""
    cfg = json.loads((ROOT / "dme_bench" / "configs" /
                      f"{name}.json").read_text())
    total = sum(n * math.prod(shape) for _, n, shape in cfg["tensors"])
    assert cfg["d"] == total
    pub = cfg["published_config"]
    assert cfg["d"] == PARAMS[pub["model_type"]](pub)


@pytest.mark.parametrize("w", M["workloads"], ids=lambda w: w["name"])
def test_cell(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["name"] == f"{w['config']}.{w['traffic']}"
    assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    assert NAME.match(w["traffic"])
    mix = json.loads((ROOT / "dme_bench" / "mixes" /
                      f"{w['traffic']}.json").read_text())
    assert (ROOT / "dme_bench" / "roles" / f"{mix['role']}.py").exists()
    mine = [m for m in METRICS if "workloads" not in m
            or w["name"] in m["workloads"]]
    e2e = {m["name"] for m in mine if m in M["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(m in M["per_layer"] for m in mine)


def test_names_are_unique():
    for group in (M["configs"], M["workloads"], METRICS):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert (ROOT / "dme_bench" / "metrics" / f"{m['name']}.py").exists()
    assert set(m.get("workloads", CELLS)) <= set(CELLS)
    if m in M["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in M["end_to_end"]}
        assert "\n" not in m["layer"] and "\t" not in m["layer"]
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_setup_bound():
    assert next(m for m in M["end_to_end"]
                if m["name"] == "setup_s")["bound"] == 0.25
