"""Core library: the paper's lattice quantization and DME/VR algorithms;
counterpart of ``repro.core``."""
from repro_torch.core.lattice import (LatticeSpec, lattice_encode,
                                      lattice_decode, pack_colors,
                                      unpack_colors, bits_for_q,
                                      shared_offset, wire_bytes)
from repro_torch.core.compressors import (Compressor, CompressorCtx, LatticeQ,
                                          RotatedLatticeQ, QSGD,
                                          HadamardUniform, TernGrad, EFSign,
                                          TopK, PowerSGDLike, FP32,
                                          make_compressor, ef_roundtrip,
                                          ALL_COMPRESSORS)
from repro_torch.core.dme import (mean_estimation_star, mean_estimation_tree,
                                  variance_reduction, butterfly_mean,
                                  DMEResult)
from repro_torch.core import rotation
from repro_torch.core import error_detect
from repro_torch.core import sublinear
from repro_torch.core import bucketing
from repro_torch.core import qstate
from repro_torch.core import wire_accounting
from repro_torch.core.qstate import QState
