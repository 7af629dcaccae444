"""The tile policy of the dequant GEMM and dx kernels.

`csrc/qtile.cuh` runs both kernels on one pipeline: a block of 4 or 8
decoder warps and 2 to 8 MMA warps computes `bm` rows (of x, or of g)
by `bn` weight-side columns, walking the contraction in steps through a
ring of shared-memory stages. This module mirrors that layout's sizes (so
the host knows each launch's stages, threads and shared memory; the entry
points check stages and bytes against their own build) and chooses the
tile per (M, O, K, qtype): 128 x 128 where its grid fills the H100's 132
SMs (`FILL`), else 64 x 128. More rows a block decode each weight element
fewer times (M / bm); serving's short prefills take the small tile and
fill the card. A warpgroup of MMA warps takes 64 rows: it holds 64 f32
sums and 64 partials of a step's wgmmas a thread (qtile.cuh
`consume_wgmma`), so a 256-row tile's would not fit the registers.

`k_order` gives the order in which a step or a dx block sees the
contraction's columns: the groups of the format's finest plane split
(`csrc/qdecode.cuh`), a permutation of K that the sums do not see.

The decode GEMV (M <= 32, `csrc/qmatmul.cu` gemv_kernel) has its own
policy, `gemv_tile`: a block of 8 warps takes 16 WR weight rows, its
WK = 8 / WR warps share the K walk, and where the row blocks alone would
not fill the card the walk is split over a cluster of KC blocks. `gemv_k_order` is the order its MMAs see K in; `lora_xa_split`
cuts the LoRA GEMV's first pass over K.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

SMS = 132  # streaming multiprocessors of an H100 SXM
# A grid fills the card when it has a block for FILL of the SMs (a
# 256 x 128 tile's 128 blocks at llama3-8b's 4096-wide projections, M =
# 1024, one wave on 97 % of the SMs, ran faster than two waves of the
# 128 x 128 tile, before the tile's sums had to fit beside their chains).
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
    """Elements of the contraction a step covers (qtile.cuh step_depth):
    128, or 64 for the byte formats, whose packed step is as large as its
    A tile."""
    return 64 if sum(PLANES[qtype]) == 8 else 128


def tiles(qtype: str) -> tuple:
    """The (bm, bn) tiles the kernels are built for, in the policy's order
    of preference."""
    return ((128, 128), (64, 128))


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
    # the MMA warps are warpgroups of 4 (wgmma, 64 rows each)
    mma_warps = 4 * (bm // 64)
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


# ---------------------------------------------------------------- GEMV
GEMV_WARPS = (8, 16)  # warps a block; 16 only where one piece holds 16 j (registers)
GEMV_TAIL = 64  # adapter columns of the LoRA arm's tail step, elements of a first-pass step
GEMV_WR = (16, 8, 4, 2, 1)  # row tiles of 16 a block, most first (at most the warps)
GEMV_KC = (1, 2, 4, 8)  # cluster ranks along K (portable cluster sizes)
GEMV_FILL = 0.72  # blocks of the GEMV's grid an SM, at least (where a tile has them)
LORA_XA_FILL = 2  # blocks of the LoRA GEMV's first pass an SM


def gemv_stages(qtype: str) -> int:
    """Ring slots a warp of the GEMV keeps: 4, or 2 for the formats whose
    16 j positions take more than one 16-byte piece."""
    return 4 if plane_split(qtype)[1] == 1 else 2


def gemv_jw(qtype: str) -> int:
    """j-blocks of 16 a lane of the GEMV takes a step: 2 where one
    16-byte piece holds 16 j positions and decodes to at most 2 groups
    (the four lanes of a row then read 128 contiguous bytes a plane, and
    two blocks' scale fields fit the registers), else 1."""
    S, pieces = plane_split(qtype)
    return 2 if pieces == 1 and S <= 2 else 1


def gemv_jstep(qtype: str) -> int:
    """j positions of a GEMV warp's step: 4 lanes x 16 x gemv_jw."""
    return 64 * gemv_jw(qtype)


def gemv_steps(K: int, qtype: str) -> int:
    """Steps in the GEMV's K walk."""
    return -(-(K // plane_split(qtype)[0]) // gemv_jstep(qtype))


def gemv_warps(qtype: str, M: int = 1) -> tuple:
    """The warps a GEMV block may have for this format and M: 16 only
    where a thread holds few registers (two j-blocks a step, one n-tile
    of 8 rows of x)."""
    return GEMV_WARPS if gemv_jw(qtype) == 2 and M <= 8 else GEMV_WARPS[:1]


def gemv_smem(M: int, K: int, qtype: str, kc: int, R: int = 0, warps: int = 8) -> int:
    """csrc/qmatmul.cu gemv_smem: the codebook, x's columns of one cluster
    rank's steps (every segment; rows 16 bytes past their width), xg of
    the LoRA arm (R > 0) and the warps' rings of pieces."""
    S, pieces = plane_split(qtype)
    spb = -(-gemv_steps(K, qtype) // kc)
    xbytes = M * (S * spb * gemv_jstep(qtype) * 2 + 16)
    gbytes = M * (-(-R // GEMV_TAIL) * GEMV_TAIL * 2 + 16) if R > 0 else 0
    return 64 + xbytes + gbytes + warps * gemv_stages(qtype) * 2 * gemv_jw(qtype) * pieces * 32 * 16


@dataclasses.dataclass(frozen=True)
class GemvTile:
    """One GEMV launch: `wr` row tiles of 16 a block (`rows` = 16 wr),
    `kc` cluster ranks along K, `warps` a block (wr of them a K slice),
    `stages` ring slots a warp, `smem` bytes, `threads` a block, `grid`
    (kc, row blocks)."""

    wr: int
    kc: int
    warps: int
    stages: int
    smem: int
    threads: int
    grid: tuple[int, int]

    @property
    def rows(self) -> int:
        return 16 * self.wr

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1]


@functools.lru_cache(maxsize=None)
def gemv_tile(M: int, O: int, K: int, qtype: str, R: int = 0) -> GemvTile | None:
    """The GEMV's tile for x [M <= 32, K] against an [O, K] weight (R > 0:
    the LoRA arm's shared memory; the tile itself does not depend on R, so
    a zero-gate row of the LoRA GEMV sums in the plain GEMV's order), or
    None where no tile holds the M rows of x (and the adapter's xg) in
    shared memory: 30 to 32 rows at gemma-3-27b's K = 21504 in sym_int4,
    29 to 32 with an adapter. `kernels.qmatmul` sends those rows to the
    GEMM, which streams x.

    The first, fewest cluster ranks first and then most rows, whose grid
    has GEMV_FILL of a block an SM with steps to walk and that fits 227 KB
    with the widest adapter the fused epilogue admits at this K; else the
    fitting one with the most such blocks. Rows go 256 a block in 16
    warps (where the format's registers allow), else 128 down to 16 in 8
    warps. A sweep of every tile at llama3-8b's shapes (scripts/gemv_sweep.py)
    put the fastest at 96-500 blocks: blocks that stream long runs of
    steps beat more, shorter ones. More rows a block read x's columns
    fewer times; a smaller cluster sums fewer partials. Kept per shape:
    a decode step asks again for every layer."""
    from bigdl_tpu_torch.ops.kernels.qmatmul import lora_fused_ok

    nsteps = gemv_steps(K, qtype)
    rmax = 4 * 1024 * 1024 // (2 * K + 2048)
    while rmax > 0 and not lora_fused_ok(rmax, K):
        rmax -= 1
    shapes = [(w, w) for w in gemv_warps(qtype, M)[1:]] + [(8, wr) for wr in GEMV_WR if wr <= 8]

    def search(r):
        best = None
        for kc in GEMV_KC:
            working = -(-nsteps // -(-nsteps // kc))  # ranks with steps
            for warps, wr in shapes:
                if gemv_smem(M, K, qtype, kc, r, warps) > SMEM_LIMIT:
                    continue
                blocks = working * math.ceil(O / (16 * wr))
                if blocks >= GEMV_FILL * SMS:
                    return blocks, warps, wr, kc
                if best is None or blocks > best[0]:
                    best = (blocks, warps, wr, kc)
        return best

    # where x's columns leave no room for the widest adapter (qwen2-7b's
    # w_down, K = 18944, at M > 16), the tile fits the GEMV alone
    best = search(rmax) or search(0)
    smem = None if best is None else gemv_smem(M, K, qtype, best[3], R, best[1])
    if smem is None or smem > SMEM_LIMIT:
        return None
    _, warps, wr, kc = best
    return GemvTile(wr, kc, warps, gemv_stages(qtype), smem, 32 * warps,
                    (kc, math.ceil(O / (16 * wr))))


def gemv_k_order(K: int, qtype: str) -> torch.Tensor:
    """The contraction's columns in the order the GEMV's MMAs see them:
    step s, j-block b of the lane's gemv_jw, segment u, k-tile t, slot c
    of the 16 (slots 2 q + e and 2 q + 8 + e are elements 4 t + e and
    4 t + 2 + e of lane q's group, u Q + jstep s + 64 b + 16 q .. + 15),
    for the j positions below Q = K / S."""
    S, _ = plane_split(qtype)
    Q = K // S
    c = torch.arange(16)
    q, e, hi = (c % 8) // 2, c % 2, c // 8
    cols = []
    for s in range(gemv_steps(K, qtype)):
        for b in range(gemv_jw(qtype)):
            for u in range(S):
                for t in range(4):
                    j = gemv_jstep(qtype) * s + 64 * b + 16 * q
                    el = u * Q + j + 4 * t + 2 * hi + e
                    cols.append(el[j < Q])
    return torch.cat(cols)


@functools.lru_cache(maxsize=None)
def lora_xa_split(R: int, K: int) -> tuple[int, int]:
    """(ks, kspb): the LoRA GEMV's first pass in ks blocks along K of kspb
    steps of 64 elements each, over ceil(R / 16) blocks of A_cat rows:
    as few steps a block as give the grid LORA_XA_FILL blocks an SM
    (a wave at least at R = 128), no block without steps."""
    nk = -(-K // GEMV_TAIL)
    want = -(-LORA_XA_FILL * SMS // -(-R // 16))
    kspb = max(1, -(-nk // max(1, min(nk, want))))
    return -(-nk // kspb), kspb
