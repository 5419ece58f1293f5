"""Assigned input-shape grid (same four cells for every LM arch)."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode | long_decode


SHAPES = {
    "train_4k":    ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k":  ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k":   ShapeSpec("long_500k", 524_288, 1, "long_decode"),
}

# long_500k needs sub-quadratic attention: run only for SSM/hybrid archs
# (DESIGN.md section Arch-applicability); every assigned arch has a decoder,
# so decode shapes run everywhere.
LONG_OK_FAMILIES = ("ssm", "hybrid")


def applicable(family: str, shape: str) -> bool:
    if shape == "long_500k":
        return family in LONG_OK_FAMILIES
    return True
