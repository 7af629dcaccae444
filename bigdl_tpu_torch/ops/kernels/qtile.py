"""The tile policy of the dequant GEMM and dx kernels.

`csrc/qtile.cuh` runs both kernels on one pipeline: a block of 4 or 8
decoder warps and 2 to 8 MMA warps computes `bm` rows (of x, or of g)
by `bn` weight-side columns, walking the contraction in steps through a
ring of shared-memory stages. This module mirrors that layout's sizes (so
the host knows each launch's stages, threads and shared memory; the entry
points check stages and bytes against their own build) and chooses the
tile per (M, O, K, qtype): the first of 256 x 128, 128 x 128 and 64 x 128
whose grid fills the H100's 132 SMs (`FILL`). More rows a block decode
each weight element fewer times (M / bm); serving's short prefills take
the small tile and fill the card. The formats whose finest plane split is
S = 8 have no 256-row tile (its ring does not fit in shared memory).

`k_order` gives the order in which a step or a dx block sees the
contraction's columns: the groups of the format's finest plane split
(`csrc/qdecode.cuh`), a permutation of K that the sums do not see.
"""

from __future__ import annotations

import dataclasses
import math

import torch

SMS = 132  # streaming multiprocessors of an H100 SXM
# A grid fills the card when it has a block for FILL of the SMs: llama3-8b's
# 4096-wide projections at M = 1024 give the large tile 128 blocks, one
# wave on 97 % of the SMs, which ran faster on the card than two waves of
# 128 x 128 tiles.
FILL = 0.96
SMEM_LIMIT = 232448  # shared memory one block may use (227 KB)
MAX_STAGES = 6

# (plane 0 bits, plane 1 bits) of every quantized format: the planes of
# csrc/qdecode.cuh's QF_<qtype> table (tests/test_torch_qmatmul.py reads
# that table and holds this one to it)
PLANES = {
    "sym_int4": (4, 0), "asym_int4": (4, 0), "nf4": (4, 0), "fp4": (4, 0),
    "sym_int8": (8, 0), "asym_int5": (8, 0), "fp8_e4m3": (8, 0), "fp8_e5m2": (8, 0),
    "sym_int5": (4, 1), "fp6": (4, 2), "nf3": (2, 1),
    "q2_k": (2, 0), "q3_k": (8, 0), "q4_k": (4, 0), "q5_k": (4, 1), "q6_k": (8, 0),
}


def plane_split(qtype: str) -> tuple[int, int]:
    """(S, pieces): the finest split of the format's planes (elements
    u*Q + j, u < S, share the bytes at j) and the 16-byte pieces that hold
    16 j positions of every plane."""
    b0, b1 = PLANES[qtype]
    s0, s1 = 8 // b0, (8 // b1 if b1 else 1)
    S = max(s0, s1)
    return S, S // s0 + (S // s1 if b1 else 0)


def depth(qtype: str) -> int:
    """Elements of the contraction a step covers: 64, or 128 where S = 8
    (a step holds whole 16-byte pieces of every plane)."""
    return 128 if plane_split(qtype)[0] == 8 else 64


def tiles(qtype: str) -> tuple:
    """The (bm, bn) tiles the kernels are built for, in the policy's order
    of preference."""
    narrow = ((128, 128), (64, 128))
    return ((256, 128),) + narrow if plane_split(qtype)[0] < 8 else narrow


@dataclasses.dataclass(frozen=True)
class Tile:
    """One launch's tile: `bm` rows by `bn` weight-side columns a block,
    `stages` ring slots in `smem` bytes of shared memory, `threads` a block,
    `grid` (blocks along M, blocks along the weight side)."""

    bm: int
    bn: int
    stages: int
    smem: int
    threads: int
    grid: tuple[int, int]

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1]

    @property
    def waves(self) -> float:
        """Blocks over the SMs: one block an SM fits (registers and shared
        memory), so ceil(waves) rounds of blocks run."""
        return self.blocks / SMS


def dec_warps(qtype: str, bm: int, rows: int, cols: int) -> int:
    """qtile.cuh's WTileFor: 8 decoder warps from 128 rows of A up where
    a step's decode units (a row's 16 j positions) spread over 256
    threads, else 4."""
    units = rows * (cols // plane_split(qtype)[0] // 16)
    return 8 if bm >= 128 and units % 256 == 0 else 4


def _layout(qtype: str, bm: int, rows: int, cols: int) -> tuple[int, int]:
    """(stages, bytes) of qtile.cuh's Layout: A slots of bm x depth bf16,
    packed slots of rows x pieces x cols/S bytes, two decoded W tiles of
    rows x cols bf16, the 16-float codebook and 1 KB of alignment for the
    swizzled layout."""
    S, pieces = plane_split(qtype)
    a_slot = bm * depth(qtype) * 2
    packed = rows * pieces * (cols // S)
    fixed = 2 * rows * cols * 2 + 16 * 4 + 1024
    stages = min(MAX_STAGES, (SMEM_LIMIT - fixed) // (a_slot + packed))
    return stages, stages * (a_slot + packed) + fixed


def _tile(M: int, side: int, qtype: str, gemm: bool) -> Tile:
    """The first tile whose grid has a block for each SM (at M > 64; the
    smallest where none has): `side` is the weight-side extent, O or K."""
    opts = tiles(qtype)
    bm, bn = next(((bm, bn) for bm, bn in opts
                   if M > 64 and math.ceil(M / bm) * math.ceil(side / bn) >= FILL * SMS), opts[-1])
    d = depth(qtype)
    rows, cols = (bn, d) if gemm else (d, bn)
    stages, smem = _layout(qtype, bm, rows, cols)
    # the MMA warps are warpgroups of 4 (wgmma, 64 or 128 rows each)
    mma_warps = 4 * max(1, bm // 128)
    return Tile(bm, bn, stages, smem, 32 * (mma_warps + dec_warps(qtype, bm, rows, cols)),
                (math.ceil(M / bm), math.ceil(side / bn)))


def gemm_tile(M: int, O: int, K: int, qtype: str) -> Tile:
    """The dequant GEMM's tile for x [M, K] against an [O, K] weight: bn
    output columns a block, W tiles of bn rows by a step of K."""
    return _tile(M, O, qtype, gemm=True)


def dx_tile(M: int, O: int, K: int, qtype: str) -> Tile:
    """The dequant dx's tile for g [M, O] against an [O, K] weight: bn dx
    columns (bn/S j positions) a block, W tiles of a step of O rows by bn
    columns."""
    return _tile(M, K, qtype, gemm=False)


def k_order(K: int, qtype: str, width: int) -> torch.Tensor:
    """The contraction's columns in the order the kernels see them, tile
    by tile of `width` columns (a GEMM step: `depth(qtype)`; a dx block:
    its bn): tile t's column 16 g + i is element (g % S) Q + t (width / S)
    + (g // S) 16 + i, Q = K / S, for the j positions below Q."""
    S, _ = plane_split(qtype)
    Q, jb = K // S, width // S
    g, i = torch.arange(width) // 16, torch.arange(width) % 16
    cols = []
    for j0 in range(0, Q, jb):
        jj = j0 + (g // S) * 16
        cols.append(((g % S) * Q + jj + i)[jj < Q])
    return torch.cat(cols)
