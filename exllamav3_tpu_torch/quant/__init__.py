from .codebook import CB_3INST, CB_MCG, CB_MUL1, decode
from .trellis import tile_perm, tile_perm_inverse, unpack_trellis
from .hadamard import HAD_K, HAD_N, hadamard_np, had_left, had_right
from .reconstruct import (
    codebook_id,
    exl3_matmul_ref,
    reconstruct_full,
    reconstruct_inner,
)
