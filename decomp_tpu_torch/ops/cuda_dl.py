"""Dictionary-learning kernels and their plain twins (counterpart of
``decomp_tpu.ops.pallas_bcd`` and of the dictionary kernel of
``decomp_tpu.ops.pallas_lasso``).

    bcd_sweep(stats_a, stats_b, d)
        -> one block-coordinate-descent pass over the atoms, in order:
           u = b_k - a_k d + a_kk d_k, then d_k <- u / ||u||, kept where
           ||u|| <= tiny (a dead atom keeps its direction)
    masked_grad_dict(my, mask, x, d)
        -> g = x^T (mask * (x d) - my): the masked dictionary gradient

``bcd_sweep`` solves the rows of ``A d = B`` (``A = x^H x`` (K, K), ``B =
x^H y`` (K, N)) one atom at a time, each step reading the rows the earlier
steps wrote (``pallas_bcd.py:82-112``). Its twin is the composition sweep of
``models.dictionary_learning``: a host loop over atoms of plain products in
the data's dtype (full f32 or f64, never TF32; real or complex).

``masked_grad_dict`` keeps the quantisation points of ``pallas_lasso.py:
201-218``: products take the data's dtype (``cdt``) as operands and sum in
f32, the residual ``cdt(f32(mask) * (x d) - f32(my))`` is formed in f32 and
cast to ``cdt``, and ``g`` is f32 (K, N). Its mask is dense, in my's shape,
or the bits of a 0/1 mask from ``cuda_mu.pack_mask`` (int32).

On a CUDA tensor a wrapper launches its kernel and raises on anything else.
``bcd_sweep`` (f32, K x N up to the TPU kernel's own gate, ``bcd_fits``) has
two routes, chosen by ``bcd_route`` from K and N alone: where d fits the
registers of one 512-thread block (K <= 256 atoms, N <= 64 channels:
``BCD_REG_MAX_ATOMS``, ``BCD_REG_MAX_CHANNELS``) ``csrc/dl_bcd_sm90.cu``
(d in registers, one barrier per atom, rows of A and B by bulk copies);
every other shape ``csrc/dl_bcd_cluster.cu`` (one thread-block cluster of
up to 8 blocks splitting the columns, d on chip where it fits and in an
L2-resident scratch past that; per atom each warp's share of ||u||^2 goes
into every block's shared memory by ``st.async`` on an mbarrier, and each
block sums the 128 shares in one fixed order; ``bcd_cluster_plan`` says
how). ``csrc/dl_bcd.cu``, the first design (one block, d in shared memory,
up to K x N = 53,248), is on no route: only the private
``_bcd_shared_launch`` reaches it, for timing. For ``masked_grad_dict``
f32 or bf16 data (bf16x6 limb products on ``wgmma`` for f32, one bf16
pass a product for bf16) launch, on the route ``cuda_lasso.grad_route``
names from K alone, for 1 <= K <= ``cuda_lasso.GRAD_MAX_FEATURES``
``csrc/grad_dict_packed.cu`` (the statistics chain of
``csrc/wgmma_chain.cuh``: a packed mask on its bits instance, a dense
mask, i.e. a weighted one, in the data's dtype on its weighted instance)
and above it, up to the TPU kernel's gate (``cuda_lasso.grad_fits``),
``csrc/grad_wide.cu`` (the residual E to device memory once, then G = x^T
E in row-chunk partials). The
GRAD_DICT variant of ``csrc/mu_kl_stats.cu``, its first design, is on no
route: only the private ``_grad_dict_dense_mma_launch`` reaches it, for
timing. On a CPU tensor it runs its ``*_plain`` twin (a
packed mask unpacked to my's dtype first). It never falls back from one to
the other. Each wrapper counts its kernel launches in ``.launches``, and
per route: ``bcd_sweep`` in ``.register_launches`` and ``.cluster_launches``,
``masked_grad_dict`` in ``.packed_launches``, ``.dense_launches`` and
``.wide_launches``.

Not ported: the TPU kernels' alignment padding (``pallas_bcd.py:44-79``,
``pallas_lasso.py:58-132``): the CUDA kernels mask ragged K and N
themselves (``bcd_sweep`` reads A and B in row strides of 4 or 8 floats,
and pads a copy where K or N is ragged). ``bcd_fits`` keeps
``pallas_bcd.fits_vmem``'s gate as the port's own predicate.
"""

import collections

import torch

from decomp_tpu_torch.ops import cuda_mu
from decomp_tpu_torch.ops.cuda_lasso import (check_masked_grad_args,
                                             check_packed_grad_args,
                                             check_weighted_grad_args,
                                             check_wide_args, grad_limb_count,
                                             grad_route, grad_tile,
                                             grad_width, wide_operands)
from decomp_tpu_torch.ops.cuda_mu import (_I, _P, _c_function, _f32, _launch,
                                          _runs_plain, _work_dtype)
from decomp_tpu_torch.utils.dtypes import real_dtype
from decomp_tpu_torch.utils.exceptions import (DecompError, DtypeError,
                                               ShapeError)
from decomp_tpu_torch.utils.normalize import l2_norm

# The shapes bcd_sweep takes: the TPU kernel's gate (pallas_bcd.py:53-65),
# the padded working set 4 (Kp^2 + 4 Kp Np) + 32 max(Kp, Np) at most
# 15 MiB, Kp = K rounded up to 8, Np = N to 128 (bcd_fits). Its corners:
# N <= 3,712 at K = 256, N <= 98,176 at K <= 8, K <= 1,736 at N <= 128.
BCD_GATE_BYTES = 15 * 2**20
_MAX_BLOCK_SMEM = 232_448      # 227 KB, the most one block may take
# bcd_sweep's cluster route (csrc/dl_bcd_cluster.cu): at most 8 blocks (the
# portable cluster size) of at most 512 threads; a ring of 4 stages of A's
# rows, 6 mbarriers (the ring's and two exchange ones) and 2 x 128 warp
# partials of ||u||^2 beside shared d.
BCD_CLUSTER_MAX = 8
_BCD_CLUSTER_THREADS = 512
# 8 groups of 4 columns a thread take at most 384 threads, so that each may
# hold 168 registers: up to 12,288 columns a block, 98,304 a cluster.
_BCD_R8_THREADS = 384
_BCD_CLUSTER_STAGES = 4
_BCD_CLUSTER_SLOTS = 128
# bcd_sweep's register route (csrc/dl_bcd_sm90.cu): a thread holds 8 rows
# x 4 columns of d (32 f32), a warp 4 columns of up to 32 x 8 = 256 rows,
# and one block at most 16 warps, 512 threads, so that each may take 128
# of the SM's 65,536 registers: K <= 256 and N <= 64.
BCD_REG_MAX_ATOMS = 256
BCD_REG_MAX_CHANNELS = 64
# masked_grad_dict's kernel runs (64-column tile) x (row chunk) blocks and
# writes one K x N partial per chunk: the chunks aim at 4 waves of the
# H100's 132 SMs in all. A function of the shape only, so the summation
# order, and every bit of g, depend on nothing else.
_GRAD_DICT_BLOCKS = 4 * 132
_STATS_TILE_COLS = 64
# Rows per chunk of masked_grad_dict's twin.
_GRAD_CHUNK_ROWS = 8192


def bcd_fits(k: int, n: int) -> bool:
    """Whether ``bcd_sweep``'s kernels take K atoms x N channels: the TPU
    kernel's gate (``pallas_bcd.fits_vmem`` after its padding), the port's
    own copy, ``4 (Kp^2 + 4 Kp Np) + 32 max(Kp, Np) <= 15 MiB`` with Kp =
    K rounded up to 8 and Np = N rounded up to 128."""
    kp, np_ = -(-k // 8) * 8, -(-n // 128) * 128
    return 4 * (kp * kp + 4 * kp * np_) + 32 * max(kp, np_) <= BCD_GATE_BYTES


def bcd_route(k: int, n: int) -> str:
    """Which kernel ``bcd_sweep`` launches for K atoms and N channels:
    ``'registers'`` (``csrc/dl_bcd_sm90.cu``) where d fits the registers of
    one block, 1 <= K <= ``BCD_REG_MAX_ATOMS`` and 1 <= N <=
    ``BCD_REG_MAX_CHANNELS``; ``'cluster'`` (``csrc/dl_bcd_cluster.cu``)
    for every other shape, which ``check_bcd_args`` then holds to
    ``bcd_fits``. A function of the shape only: no shape moves to another
    route on a failure."""
    if 1 <= k <= BCD_REG_MAX_ATOMS and 1 <= n <= BCD_REG_MAX_CHANNELS:
        return "registers"
    return "cluster"


def bcd_cluster_size(k: int, n: int) -> int:
    """The blocks of ``csrc/dl_bcd_cluster.cu``'s cluster for K x N, 1 to
    ``BCD_CLUSTER_MAX``: a function of the shape alone, so the column
    split, the summation order and every bit of d depend on nothing
    else. One block for every group of 4 columns, up to 8: on the H100
    the sweep was fastest, or within a few per cent of it, on 8 blocks at
    every shape from 256 x 65 to the TPU gate's corners
    (``tools/bcd_cluster_turns.py``)."""
    return min(BCD_CLUSTER_MAX, -(-n // 4))


BcdClusterPlan = collections.namedtuple(
    "BcdClusterPlan", "clusters threads nb r sets lanes on_sets l4 ldw lda "
    "ldb smem_bytes")


def _bcd_l4(slots: int, lanes: int) -> int:
    """Row stride of shared d in float4 slots, at least ``slots``, so that
    the 8 lanes of a 16-byte read hit 8 distinct bank groups: lane p of
    set s reads slot p l4 + s, so l4 is odd for 8 or more lanes a set, 2
    (mod 8) for 4, 4 (mod 8) for 2 and anything for 1."""
    if slots == 0 or lanes == 1:
        return slots
    if lanes >= 8:
        return slots | 1
    return slots + (8 // lanes - slots) % 8


def bcd_cluster_plan(k: int, n: int) -> BcdClusterPlan:
    """How ``csrc/dl_bcd_cluster.cu`` splits K x N, on
    ``bcd_cluster_size(K, N)`` blocks. Each block owns ``nb`` consecutive
    columns (ceil(N / clusters) rounded up to 4; the last blocks may own
    fewer, or none), cut into groups of 4 columns; ``r`` groups (1, 2, 4
    or 8: the fewest that leave at most 512 sets, 384 for 8) make a set,
    set s holding groups s, s + sets, ...; each set's rows are split over
    ``lanes`` lanes (the largest power of two <= K and <= 32 with sets x
    lanes <= 512), lane p taking rows p, p + lanes, ...; ``threads`` is
    sets x lanes rounded up to a warp. The first ``on_sets`` sets (all
    that fit, in whole warps) keep d in shared memory in rows of ``l4``
    float4 slots, the others in a global scratch of ``ldw`` floats a row
    per block. A and B go in row strides ``lda`` and ``ldb`` (K and N
    rounded up to 4)."""
    return _bcd_cluster_plan_at(k, n, bcd_cluster_size(k, n))


def _bcd_cluster_plan_at(k: int, n: int, c: int) -> BcdClusterPlan:
    """``bcd_cluster_plan`` on a cluster of ``c`` blocks (the tests and
    ``tools/bcd_cluster_turns.py`` try other sizes than the route's)."""
    nb = -(-(-(-n // c)) // 4) * 4
    groups = nb // 4
    if groups > 8 * _BCD_R8_THREADS:
        raise ShapeError(f"bcd_sweep's cluster of {c} blocks cannot split "
                         f"N={n}: more than 12,288 columns a block")
    r = next(r for r in (1, 2, 4, 8)
             if -(-groups // r) <= (_BCD_R8_THREADS if r == 8
                                    else _BCD_CLUSTER_THREADS))
    sets = -(-groups // r)
    lanes = 32
    while lanes > 1 and (sets * lanes > _BCD_CLUSTER_THREADS or lanes > k):
        lanes //= 2
    threads = -(-sets * lanes // 32) * 32
    lda, ldb = -(-k // 4) * 4, -(-n // 4) * 4
    fixed = (4 * _BCD_CLUSTER_STAGES * lda + 8 * (_BCD_CLUSTER_STAGES + 2)
             + 4 * 2 * _BCD_CLUSTER_SLOTS)
    per_warp = 32 // lanes
    on = sets
    while on and fixed + 16 * k * _bcd_l4(r * on, lanes) > _MAX_BLOCK_SMEM:
        on = (on - 1) // per_warp * per_warp
    l4 = _bcd_l4(r * on, lanes)
    return BcdClusterPlan(c, threads, nb, r, sets, lanes, on, l4,
                          4 * r * (sets - on), lda, ldb, fixed + 16 * k * l4)


def bcd_reg_strides(k: int, n: int) -> tuple:
    """The row strides (lda, ldb) in which the register route reads A and
    B: K rounded up to 8 (a lane's 8 entries of a row of A are two float4
    loads) and N up to 4 (a warp's 4 columns of a row of B are one)."""
    return -(-k // 8) * 8, -(-n // 4) * 4


def _bcd_rows(t, ld):
    """``t`` (rows, cols) as contiguous rows of stride ``ld``, zero past
    ``cols``, 16-byte aligned (the bulk copies' rule): ``t`` itself where
    it already is, else a padded copy."""
    if (t.shape[1] == ld and t.is_contiguous() and t.data_ptr() % 16 == 0):
        return t
    out = torch.zeros((t.shape[0], ld), dtype=t.dtype, device=t.device)
    out[:, :t.shape[1]] = t
    return out


def bcd_sweep_plain(stats_a, stats_b, d):
    """``bcd_sweep``'s plain twin: a host loop over the atoms in d's dtype
    (``decomp_tpu``'s ``_bcd_dict_update`` composition). Returns a new
    tensor."""
    rdt = real_dtype(d.dtype)
    tiny = torch.tensor(torch.finfo(rdt).tiny, dtype=rdt, device=d.device)
    d = d.clone()
    for k in range(d.shape[0]):
        a_row = stats_a[k]
        u = stats_b[k] - a_row @ d + a_row[k].real.to(d.dtype) * d[k]
        norm = l2_norm(u)
        d[k] = torch.where(norm > tiny, u / torch.maximum(norm, tiny), d[k])
    return d


def check_bcd_args(stats_a, stats_b, d):
    """Refuse what ``bcd_sweep``'s kernel does not take, before any
    launch."""
    for name, t in (("stats_a", stats_a), ("stats_b", stats_b), ("d", d)):
        if t.device != d.device:
            raise DecompError(f"{name} is on {t.device}, d on {d.device}")
        if t.dtype != torch.float32:
            raise DtypeError(f"the BCD sweep kernel takes f32 {name}, got "
                             f"{t.dtype}")
        if t.dim() != 2:
            raise ShapeError(f"{name} must be 2-D, got {tuple(t.shape)}")
    k, n = d.shape
    if stats_a.shape != (k, k) or stats_b.shape != (k, n):
        raise ShapeError(f"stats_a {tuple(stats_a.shape)} and stats_b "
                         f"{tuple(stats_b.shape)} do not fit d {(k, n)}")
    if k < 1 or n < 1 or not bcd_fits(k, n):
        raise ShapeError(
            "the BCD sweep kernels take K x N whose padded working set "
            "4 (Kp^2 + 4 Kp Np) + 32 max(Kp, Np) is at most 15 MiB (Kp = K "
            "rounded up to 8, Np = N to 128: up to 256 x 3,712, 8 x 98,176 "
            f"or 1,736 x 128), got K={k}, N={n} (larger dictionaries: "
            "_bcd_kernel=False)")


def bcd_sweep(stats_a, stats_b, d):
    """One BCD pass over the atoms; see the module docstring. ``stats_a``
    (K, K), ``stats_b`` and ``d`` (K, N). Returns the swept (K, N)
    dictionary as a new tensor. On a CUDA tensor it launches the kernel of
    ``bcd_route(K, N)`` and counts it in ``.register_launches`` or
    ``.cluster_launches``; ``.launches`` counts both."""
    if _runs_plain(d):
        return bcd_sweep_plain(stats_a, stats_b, d)
    check_bcd_args(stats_a, stats_b, d)
    if bcd_route(*d.shape) == "registers":
        out = _bcd_registers_launch(stats_a, stats_b, d)
        bcd_sweep.register_launches += 1
    else:
        out = _bcd_cluster_launch(stats_a, stats_b, d)
        bcd_sweep.cluster_launches += 1
    bcd_sweep.launches += 1
    return out


bcd_sweep.launches = 0
bcd_sweep.register_launches = 0
bcd_sweep.cluster_launches = 0


def _bcd_registers_launch(stats_a, stats_b, d):
    """Launch ``csrc/dl_bcd_sm90.cu`` (``bcd_sweep``'s register route), A
    and B in the row strides of ``bcd_reg_strides``."""
    k, n = d.shape
    lda, ldb = bcd_reg_strides(k, n)
    fn = _c_function("dl_bcd_sm90", "bcd_sweep_sm90_launch",
                     (_P,) * 3 + (_I,) * 4 + (_P,) * 2)
    with torch.cuda.device(d.device):
        ac, bc = _bcd_rows(stats_a, lda), _bcd_rows(stats_b, ldb)
        dc = d.contiguous()
        out = torch.empty((k, n), dtype=torch.float32, device=d.device)
        _launch("bcd_sweep", fn, d.device, ac.data_ptr(), bc.data_ptr(),
                dc.data_ptr(), k, n, lda, ldb, out.data_ptr())
    return out


def _bcd_cluster_launch(stats_a, stats_b, d):
    """Launch ``csrc/dl_bcd_cluster.cu`` (``bcd_sweep``'s cluster route) on
    ``bcd_cluster_plan(K, N)``."""
    return _bcd_cluster_run(stats_a, stats_b, d, bcd_cluster_plan(*d.shape))


def _bcd_cluster_run(stats_a, stats_b, d, plan):
    """``csrc/dl_bcd_cluster.cu`` on ``plan``: A and B in row strides of 4
    floats, d's columns past the plan's shared memory in a scratch of
    ``clusters x K x ldw`` floats."""
    k, n = d.shape
    fn = _c_function("dl_bcd_cluster", "bcd_sweep_cluster_launch",
                     (_P,) * 5 + (_I,) * 13 + (_P,))
    with torch.cuda.device(d.device):
        ac, bc = _bcd_rows(stats_a, plan.lda), _bcd_rows(stats_b, plan.ldb)
        dc = d.contiguous()
        out = torch.empty((k, n), dtype=torch.float32, device=d.device)
        dw = (_f32(plan.clusters * k * plan.ldw, d.device) if plan.ldw
              else None)
        _launch("bcd_sweep", fn, d.device, ac.data_ptr(), bc.data_ptr(),
                dc.data_ptr(), out.data_ptr(),
                0 if dw is None else dw.data_ptr(), k, n, plan.lda, plan.ldb,
                plan.clusters, plan.threads, plan.nb, plan.r, plan.sets,
                plan.lanes, plan.on_sets, plan.l4, plan.ldw)
    return out


def _bcd_shared_launch(stats_a, stats_b, d):
    """Launch ``csrc/dl_bcd.cu``, ``bcd_sweep``'s first design (one block,
    d in shared memory, K x N <= 53,248), on no route: kept to be timed
    in turns with the cluster route."""
    k, n = d.shape
    fn = _c_function("dl_bcd", "bcd_sweep_launch",
                     (_P,) * 3 + (_I,) * 2 + (_P,) * 2)
    with torch.cuda.device(d.device):
        ac, bc, dc = (t.contiguous() for t in (stats_a, stats_b, d))
        out = torch.empty((k, n), dtype=torch.float32, device=d.device)
        _launch("bcd_sweep", fn, d.device, ac.data_ptr(), bc.data_ptr(),
                dc.data_ptr(), k, n, out.data_ptr())
    return out


def masked_grad_dict_plain(my, mask, x, d, *, block_rows=None):
    """``masked_grad_dict``'s plain twin (``_grad_dict_kernel``,
    ``pallas_lasso.py:201``), in row chunks of ``block_rows`` summed in
    f32 in chunk order. As in the TPU kernel, the products' sums, the
    residual and g are f32 even for f64 data."""
    cdt, wdt, f32 = my.dtype, _work_dtype(my.dtype), torch.float32
    dw = d.to(wdt)
    g = torch.zeros(d.shape, dtype=f32, device=my.device)
    rows = block_rows or _GRAD_CHUNK_ROWS
    for s in range(0, my.shape[0], rows):
        sl = slice(s, s + rows)
        xc = x[sl].to(cdt).to(wdt)
        recon = (xc @ dw).to(f32)
        resid = (mask[sl].to(f32) * recon - my[sl].to(f32)).to(d.dtype)
        g += (xc.T @ resid.to(wdt)).to(f32)
    return g


def grad_dict_chunk_rows(m: int, n: int) -> int:
    """Rows per partial of ``masked_grad_dict``'s kernel: about
    ``_GRAD_DICT_BLOCKS`` blocks over the (64-column tile) x (chunk) grid,
    in multiples of 32 rows."""
    tiles = -(-n // _STATS_TILE_COLS)
    chunks = max(1, -(-_GRAD_DICT_BLOCKS // tiles))
    rows = -(-m // chunks)
    return -(-rows // 32) * 32


def masked_grad_dict(my, mask, x, d):
    """The masked dictionary gradient ``x^T (mask * (x d) - my)`` (K, N) in
    f32; ``my`` is the pre-masked data ``mask * y`` (M, N), ``x`` (M, K),
    ``d`` (K, N). The M x N residual never reaches device memory.

    ``mask`` is dense, in my's shape and dtype (a weighted mask), or the
    bits of a 0/1 mask from ``cuda_mu.pack_mask`` (int32). On a CUDA tensor
    (f32 or bf16 data) K <= 128 launches ``csrc/grad_dict_packed.cu``, its
    instance by the dtype and the mask's form: a packed mask counts in
    ``.packed_launches``, a dense one (the weights streamed beside my) in
    ``.dense_launches``; K above 128, up to the gate
    (``cuda_lasso.grad_fits``), launches ``csrc/grad_wide.cu`` on either
    form, counted in ``.wide_launches``; ``.launches`` counts all three.
    On a CPU tensor a
    packed mask is unpacked to my's dtype for the twin, which then gives
    the dense mask's bits."""
    packed = mask.dtype == torch.int32
    if packed:
        cuda_mu._check_packed(my, mask)
    if _runs_plain(my):
        if packed:
            mask = cuda_mu.unpack_mask(mask, my.shape[1], my.dtype)
        return masked_grad_dict_plain(my, mask, x, d)
    if grad_route(d.shape[0]) == "wide":
        g = _grad_dict_wide_launch(my, mask, x, d)
        masked_grad_dict.wide_launches += 1
    elif packed:
        g = _grad_dict_packed_launch(my, mask, x, d)
        masked_grad_dict.packed_launches += 1
    else:
        g = _grad_dict_weighted_launch(my, mask, x, d)
        masked_grad_dict.dense_launches += 1
    masked_grad_dict.launches += 1
    return g


masked_grad_dict.launches = 0
masked_grad_dict.packed_launches = 0
masked_grad_dict.dense_launches = 0
masked_grad_dict.wide_launches = 0


def grad_dict_packed_rows(m: int, n: int) -> int:
    """Rows per partial of ``csrc/grad_dict_packed.cu``: the grid of dense
    KL's statistics pass, whose chain it runs (``cuda_mu.
    kl_packed_block_rows``: two waves of 128-column N tiles over the H100's
    132 SMs, whole 32-row stages; 33 chunks of 3,040 rows at 100,000 x
    1,024). A function of the shape alone, so the summation order, and
    every bit of G, is."""
    return cuda_mu.kl_packed_block_rows(m, n)


def grad_wide_dict_rows(m: int, n: int, k: int) -> int:
    """Rows per partial of ``csrc/grad_wide.cu``'s dictionary gradient:
    ``cuda_mu.wide_dict_rows`` at K rounded up to 128 (17 chunks of 5,888
    rows at 100,000 x 1,024, K = 256; 4 of 4,096 at 16,384 x 128, K =
    10,112). A function of the shape alone, so the summation order, and
    every bit of G, is."""
    return cuda_mu.wide_dict_rows(m, n, grad_width(k))


def _split_rows(x, kt):
    """x (M, K) as the f32 dictionary kernels stream it: (M, 3 kt) bf16,
    row m = [limb 0 of x[m] | limb 1 | limb 2] in ``cuda_mu.split_bf16x3``'s
    round-to-nearest limbs, each zero past K: ``cuda_mu.column_limbs(x^T,
    kt)``, kt = ``cuda_lasso.grad_width(K)``. On a CUDA tensor the split
    launch that both f32 dictionary kernels run (``split_rows`` of
    ``csrc/sm90_common.cuh``, through ``csrc/grad_dict_packed.cu``'s entry)
    writes it: the card's check of its layout; the main path runs it
    inside ``masked_grad_dict``. On a CPU tensor ``column_limbs``."""
    if _runs_plain(x):
        return cuda_mu.column_limbs(x.T, kt)
    m, k = x.shape
    fn = _c_function("grad_dict_packed", "grad_dict_split_launch",
                     (_I, _P, _I, _I, _P, _P))
    with torch.cuda.device(x.device):
        xc = x.contiguous()
        out = torch.empty((m, 3 * kt), dtype=torch.bfloat16, device=x.device)
        _launch("masked_grad_dict (split)", fn, x.device, kt, xc.data_ptr(),
                m, k, out.data_ptr())
    return out


def _grad_dict_packed_launch(my, packed, x, d):
    """Launch ``csrc/grad_dict_packed.cu`` on f32 or bf16 ``my`` and the
    packed mask (``masked_grad_dict``'s packed route), the instance of
    ``cuda_lasso.grad_limb_count(my.dtype)`` limbs. d's limbs go to the
    kernel as ``cuda_mu.column_limbs(d, KT, limbs)``, made once per call;
    f32 x's limbs are split by the kernel's first launch, bf16 x is
    streamed as it is (a padded copy where K % 8 != 0, as TMA needs)."""
    check_packed_grad_args(my, packed, x, d)
    packed = packed.contiguous()
    if packed.data_ptr() % 16:
        packed = packed.clone()
    return _grad_dict_chain(my, x, d, "grad_dict_packed_launch", packed,
                            packed.shape[1])


def _grad_dict_weighted_launch(my, w, x, d):
    """Launch ``csrc/grad_dict_packed.cu``'s weighted instance on f32 or
    bf16 ``my`` and the dense mask ``w`` in my's dtype
    (``masked_grad_dict``'s dense route), launches as
    ``_grad_dict_packed_launch``'s with the weights (16-byte-aligned rows,
    as my's) for the bits."""
    check_weighted_grad_args(my, w, x, d)
    with torch.cuda.device(my.device):
        w_t, ld_w = cuda_mu._tma_rows(w.contiguous())
        return _grad_dict_chain(my, x, d, "grad_dict_weighted_launch", w_t,
                                ld_w)


def _grad_dict_wide_launch(my, mask, x, d):
    """Launch ``csrc/grad_wide.cu``'s dictionary gradient
    (``masked_grad_dict``'s wide route) on f32 or bf16 ``my`` with the
    packed mask or the weights: x's limbs (f32), E, the row chunks'
    partials of G = x^T E and their fixed-order sum. d's limbs go to the
    kernel as ``cuda_mu.column_limbs(d, grad_width(K), limbs)``, made once
    per call (d changes every outer iteration); G (K, N) f32."""
    check_wide_args(my, mask, x, d)
    m, n = my.shape
    k = d.shape[0]
    kp = grad_width(k)
    rows = grad_wide_dict_rows(m, n, k)
    fn = _c_function("grad_wide", "grad_wide_dict_launch",
                     (_I, _I, _P, _I, _P, _I, _P, _I, _P) + (_I,) * 5
                     + (_P, _P, _I, _P, _P, _P))
    with torch.cuda.device(my.device):
        my_t, ld_my, mask_t, ld_mask, weighted, x_t, ld_x, xl, e = \
            wide_operands(my, mask, x)
        d_limbs = cuda_mu.column_limbs(d, kp, grad_limb_count(my.dtype))
        part = _f32(-(-m // rows) * k * n, my.device)
        out = _f32(k * n, my.device)
        _launch("masked_grad_dict (grad_wide_dict_launch)", fn, my.device,
                grad_limb_count(my.dtype), weighted, my_t.data_ptr(), ld_my,
                mask_t.data_ptr(), ld_mask, x_t.data_ptr(), ld_x,
                d_limbs.data_ptr(), m, n, k, kp, rows,
                0 if xl is None else xl.data_ptr(), e.data_ptr(), ld_my,
                part.data_ptr(), out.data_ptr())
    return out.view(k, n)


def _grad_dict_chain(my, x, d, entry, mask, ld_mask):
    """Call ``csrc/grad_dict_packed.cu``'s C entry ``entry`` with the mask
    (the bits, ``ld_mask`` words a row, or the weights, row stride
    ``ld_mask``); G (K, N) f32."""
    m, n = my.shape
    k = d.shape[0]
    kt = grad_tile(k)
    limbs = grad_limb_count(my.dtype)
    rows = grad_dict_packed_rows(m, n)
    fn = _c_function("grad_dict_packed", entry,
                     (_I, _I, _P, _I, _P, _I, _P, _I, _P) + (_I,) * 4
                     + (_P,) * 4)
    with torch.cuda.device(my.device):
        my_t, ld_my = cuda_mu._tma_rows(my.contiguous())
        d_limbs = cuda_mu.column_limbs(d, kt, limbs)
        x_limbs = None   # f32: the split launch's output (M, 3 KT)
        if limbs == 3:
            x_t, ld_x = x.contiguous(), k
            x_limbs = torch.empty((m, 3 * kt), dtype=torch.bfloat16,
                                  device=my.device)
        else:
            x_t, ld_x = cuda_mu._tma_rows(x.contiguous())
        part = _f32(-(-m // rows) * k * n, my.device)
        out = _f32(k * n, my.device)
        _launch(f"masked_grad_dict ({entry})", fn, my.device, limbs, kt,
                my_t.data_ptr(), ld_my, mask.data_ptr(), ld_mask,
                x_t.data_ptr(), ld_x, d_limbs.data_ptr(), m, n, k, rows,
                0 if x_limbs is None else x_limbs.data_ptr(),
                part.data_ptr(), out.data_ptr())
    return out.view(k, n)


def _grad_dict_dense_mma_launch(my, mask, x, d):
    """Launch the GRAD_DICT variant of ``csrc/mu_kl_stats.cu``, the first
    design of the dense-mask gradient, on no route of ``masked_grad_dict``:
    kept to be timed beside the weighted instance. Counts nothing."""
    check_masked_grad_args(my, mask, x, d)
    m, n = my.shape
    k = d.shape[0]
    rows = grad_dict_chunk_rows(m, n)
    fn = _c_function("mu_kl_stats", "masked_grad_dict_launch",
                     (_I,) + (_P,) * 4 + (_I,) * 4 + (_P,) * 3)
    with torch.cuda.device(my.device):
        myc, maskc, xc, dc = (t.contiguous() for t in (my, mask, x, d))
        part = _f32(-(-m // rows) * k * n, my.device)
        out = _f32(k * n, my.device)
        _launch("masked_grad_dict", fn, my.device,
                int(my.dtype == torch.bfloat16), myc.data_ptr(),
                maskc.data_ptr(), xc.data_ptr(), dc.data_ptr(), m, n, k, rows,
                part.data_ptr(), out.data_ptr())
    return out.view(k, n)
