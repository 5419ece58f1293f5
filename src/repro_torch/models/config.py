"""Architecture configuration dataclass shared by every model family;
a copy of ``repro.models.config`` (the port imports nothing of the
reference)."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    d_ff: int
    vocab: int
    act: str = "swiglu"         # swiglu | squared_relu | gelu
    qk_norm: bool = False
    rope_theta: float = 10000.0
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 256
    ssm_groups: int = 1
    conv_width: int = 4
    # hybrid (RG-LRU + local attention)
    window: int = 0             # local-attention window (0 = full)
    pattern: tuple[str, ...] = ()   # block pattern, e.g. ("rec","rec","attn")
    lru_width: int = 0
    # encoder-decoder
    enc_layers: int = 0
    enc_seq: int = 0            # e.g. whisper 1500 frames
    # vlm
    img_tokens: int = 0
    norm_eps: float = 1e-5
    emb_scale: float = 1.0
    tie_embeddings: bool = False

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv, 1)

    def kv_groups(self, tp: int) -> int:
        """g1 for decode: largest divisor of tp that divides n_kv."""
        g = 1
        k = 2
        while k <= tp:
            if tp % k == 0 and self.n_kv % k == 0:
                g = k
            k *= 2
        return g

    def param_count(self) -> int:
        """Approximate dense-equivalent parameter count (global)."""
        D, H, KV, hd, F, V, L = (self.d_model, self.n_heads, self.n_kv,
                                 self.head_dim, self.d_ff, self.vocab,
                                 self.n_layers)
        attn = D * H * hd + 2 * D * KV * hd + H * hd * D
        if self.family == "ssm":
            inner = self.ssm_expand * D
            per_layer = D * (2 * inner + 2 * self.ssm_groups * self.ssm_state
                             + inner // self.ssm_headdim) + inner * D
        elif self.family == "moe":
            mlp = self.n_experts * (3 * D * F if self.act == "swiglu" else 2 * D * F)
            per_layer = attn + mlp
        else:
            mlp = 3 * D * F if self.act == "swiglu" else 2 * D * F
            per_layer = attn + mlp
        total = L * per_layer + 2 * V * D
        if self.family == "encdec":
            total += self.enc_layers * (attn + per_layer - attn) + L * attn  # cross-attn
        return int(total)

    def active_param_count(self) -> int:
        if self.family != "moe":
            return self.param_count()
        D, F, L = self.d_model, self.d_ff, self.n_layers
        attn = (D * self.n_heads * self.head_dim + 2 * D * self.n_kv * self.head_dim
                + self.n_heads * self.head_dim * D)
        mlp = self.top_k * (3 * D * F if self.act == "swiglu" else 2 * D * F)
        return int(L * (attn + mlp) + 2 * self.vocab * D)
