"""What ``solve_rows``' 'high' kernel (``csrc/lasso_fista_tma.cu``) relies
on, checked on the host: the complex mode's pair Gram, expanded into the
fragments the kernel builds in registers, carries the bits of the real
embedding that ``csrc/lasso_fista.cu`` reads; a row's result does not
depend on where it runs in the batch (the slots refilled from a queue); the
wrapper's routes and refusals. The kernel itself runs only on the card
(``chip_smoke.py`` holds it bit for bit against ``csrc/lasso_fista.cu``)."""

import numpy as np
import pytest
import torch

from decomp_tpu.ops import pallas_fista
from decomp_tpu_torch.ops import cuda_lasso
from decomp_tpu_torch.utils import exceptions as texc
from problems import rel_err

_METHODS = {"ista": (False, False), "fista": (True, False),
            "acc_ista": (True, True)}
_SIGN = -32768   # 0x8000, the sign bit of a bf16 as an int16


def _hermitian(seed, fc, n=40):
    """A complex64 Hermitian Gram with negative parts, exact zeros (a real
    diagonal, a zeroed pair of entries and a zeroed imaginary part) and
    entries exact in bf16 (whose low half is +0)."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(fc, n)) + 1j * rng.normal(size=(fc, n))
    g = a @ a.conj().T / n
    g[1, 2] = g[2, 1] = 0.0
    g[0, 3] = g[0, 3].real
    g[3, 0] = g[0, 3]
    g[2, 4], g[4, 2] = -0.5 + 0.25j, -0.5 - 0.25j
    np.fill_diagonal(g, g.diagonal().real)
    return torch.from_numpy(g.astype(np.complex64))


def _fragment_halves(ph, plo):
    """The kernel's B fragments (``embed_pair`` of lasso_fista_tma.cu) of
    the pair Gram's halves, as the (2 Fc, 2 Fc) bf16 matrix whose row n
    holds B(k, n) over k: for output column 2 nu the pair (Re, -Im), for 2
    nu + 1 (Im, Re); hi's sign always flips, lo's unless lo is +0."""
    fc = ph.shape[0]
    out = []
    for half, keep_zero in ((ph, False), (plo, True)):
        w = half.contiguous().view(torch.int16).reshape(fc, fc, 2)
        re, im = w[..., 0], w[..., 1]
        neg = im ^ _SIGN
        if keep_zero:
            neg = torch.where(im == 0, im, neg)
        even = torch.stack([re, neg], -1)    # (nu, kappa, j)
        odd = torch.stack([im, re], -1)
        rows = torch.stack([even, odd], 1)   # (nu, parity, kappa, j)
        out.append(rows.reshape(2 * fc, 2 * fc).view(torch.bfloat16))
    return out


@pytest.mark.parametrize("seed,fc", [(0, 5), (1, 8), (2, 37), (3, 64)])
def test_pair_fragments_are_the_embedding_bit_for_bit(seed, fc):
    g = _hermitian(seed, fc)
    pairs = cuda_lasso.pair_gram(g)
    assert pairs.shape == (fc, 2 * fc) and pairs.dtype == torch.float32
    got = _fragment_halves(*cuda_lasso.split_hi_lo(pairs))
    ref = cuda_lasso.split_hi_lo(cuda_lasso.embed_gram(g).T)
    for a, b in zip(got, ref):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    # The exact zeros and bf16-exact entries are there to be checked.
    lo = ref[1].view(torch.int16)
    assert bool((lo == 0).any()) and bool((pairs == 0).any())
    assert bool((pairs < 0).any())


def test_pair_gram_layout_and_its_embedding():
    """Row n of the pair Gram is column n of the complex Gram as pairs, and
    the same pairs sit at even rows of the embedding."""
    g = _hermitian(4, 6)
    pairs = cuda_lasso.pair_gram(g)
    assert torch.equal(pairs[:, 0::2], g.real.T)
    assert torch.equal(pairs[:, 1::2], g.imag.T)
    assert torch.equal(cuda_lasso._pairs_of_embedding(
        cuda_lasso.embed_gram(g)), pairs)


@pytest.mark.parametrize("f,group,rows", [
    (5, False, [8]), (64, False, [64]), (200, False, [200]),
    (600, False, [512, 88]), (1024, False, [512, 512]), (100, True, [52]),
    (512, True, [256]), (600, True, [256, 44]), (1024, True, [256, 256])])
def test_tile_images_read_back_with_the_kernels_addressing(f, group, rows):
    """Each chunk's tiles hold only the rows its columns read (whole
    8-column groups; pair rows in the complex mode), so a narrow F copies
    no padding. Read as the kernel reads a stage (element k of row r at r
    16 + 8 ((k / 8) ^ ((r >> 2) & 1)) + k % 8, the lo tile after the hi),
    the images hold the bf16x3 halves of every row, and zeros past the
    matrix."""
    n = f // 2 if group else f
    v = torch.from_numpy(np.random.default_rng(f).normal(
        size=(n, f)).astype(np.float32))
    assert cuda_lasso.stage_rows(f, group) == rows
    img = cuda_lasso.tile_images(v, group).view(torch.int16)
    nks = -(-f // 16)
    assert img.shape == (nks * 2 * sum(rows) * 16,)
    first = 256 if group else 512
    want = [h.view(torch.int16) for h in cuda_lasso.split_hi_lo(v)]
    for c, (chunk, r_c) in enumerate(zip(
            img.split([nks * 2 * r * 16 for r in rows]), rows)):
        r, kk = torch.arange(r_c), torch.arange(16)
        col = (8 * ((kk[None, :] // 8) ^ ((r[:, None] >> 2) & 1))
               + kk[None, :] % 8)
        read = chunk.reshape(nks, 2, r_c, 16).gather(
            -1, col.expand(nks, 2, r_c, 16))
        read = read.permute(1, 2, 0, 3).reshape(2, r_c, nks * 16)
        for got, w in zip(read, want):
            part = w[c * first:c * first + r_c]
            assert torch.equal(got[:part.shape[0], :f], part)
            assert not bool(got[part.shape[0]:].any())
            assert not bool(got[:, f:].any())
        # The rows cover every column the chunk computes.
        cols = min(512, f - 512 * c)
        assert r_c * (2 if group else 1) >= cols


def _batch(seed, m, f, complex_):
    """A small solve_rows problem as CPU tensors, rows 3 and 11 resuming
    done."""
    rng = np.random.default_rng(seed)
    n = 3 * f

    def normal(*shape):
        z = rng.normal(size=shape)
        return z + 1j * rng.normal(size=shape) if complex_ else z

    a = normal(f, n) / np.sqrt(n)
    gram = a @ a.conj().T
    xt = normal(m, f) * (rng.random((m, f)) < 0.2)
    yah = (xt @ a + 0.01 * normal(m, n)) @ a.conj().T
    dt = np.complex64 if complex_ else np.float32
    step = np.float32(1.0 / (1.02 * np.linalg.eigvalsh(gram)[-1]))
    x0 = (0.1 * normal(m, f)).astype(dt)
    t0 = np.ones((m, 1), np.float32)
    d0 = np.zeros((m, 1), np.float32)
    d0[[3, 11]] = 1.0
    n0 = np.zeros((m, 1), np.int32)
    n0[[3, 11]] = 7
    vals = (yah.astype(dt), gram.astype(dt), x0, x0, t0, d0, n0)
    return [torch.from_numpy(v) for v in vals], float(step)


@pytest.mark.parametrize("method", list(_METHODS))
@pytest.mark.parametrize("fixed", [False, True])
@pytest.mark.parametrize("complex_", [False, True])
def test_twin_rows_do_not_depend_on_their_place(method, fixed, complex_):
    """solve_rows' twin on a row-permuted batch gives the permuted outputs
    bit for bit: the property that lets the 'high' kernel run any row in
    any slot of any block."""
    m, f = 40, 12 if complex_ else 24
    (yah, gram, x0, z0, t0, d0, n0), step = _batch(7, m, f, complex_)
    mom, rst = _METHODS[method]
    kw = dict(momentum=mom, restart=rst, maxiter=60, hi_lo=True, fixed=fixed)
    tol = 0.0 if fixed else 1e-4
    perm = torch.from_numpy(np.random.default_rng(8).permutation(m))
    ref = cuda_lasso.solve_rows_plain(yah, gram, x0, z0, t0, d0, n0, step,
                                      0.05 * step, tol, **kw)
    got = cuda_lasso.solve_rows_plain(yah[perm], gram, x0[perm], z0[perm],
                                      t0[perm], d0[perm], n0[perm], step,
                                      0.05 * step, tol, **kw)
    for a, b in zip(got, ref):
        assert torch.equal(a, b[perm])
    assert torch.equal(ref[0][3], x0[3]) and int(ref[4][11, 0]) == 7
    if not fixed:   # rows stop on their own, at different iterations
        assert len(set(ref[4][:, 0].tolist())) > 3


@pytest.mark.parametrize("complex_", [False, True])
def test_cpu_runs_the_twin_and_counts_no_launch(complex_):
    (yah, gram, x0, z0, t0, d0, n0), step = _batch(9, 24, 10, complex_)
    before = (cuda_lasso.solve_rows.launches,
              cuda_lasso.solve_rows.tma_launches)
    kw = dict(momentum=True, restart=True, maxiter=30, hi_lo=True)
    got = cuda_lasso.solve_rows(yah, gram, x0, z0, t0, d0, n0, step,
                                0.05 * step, 1e-4, **kw)
    ref = cuda_lasso.solve_rows_plain(yah, gram, x0, z0, t0, d0, n0, step,
                                      0.05 * step, 1e-4, **kw)
    assert before == (cuda_lasso.solve_rows.launches,
                      cuda_lasso.solve_rows.tma_launches)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def _embedding_of_pairs(pairs):
    """The (2 Fc, 2 Fc) embedding of a pair Gram (``pair_gram``)."""
    fc = pairs.shape[0]
    p = pairs.reshape(fc, fc, 2).transpose(0, 1)   # (kappa, nu, j)
    re, im = p[..., 0], p[..., 1]
    rows = torch.stack([torch.stack([re, im], -1),
                        torch.stack([-im, re], -1)], 1)
    return rows.reshape(2 * fc, 2 * fc)


@pytest.fixture
def routed(monkeypatch):
    """solve_rows as if on the card: the kernels' launches recorded, each
    replaced by the twin on the Gram it was given (a pair Gram expanded)."""
    calls = []

    def tma(yah, gram, x0, z0, t0, done0, nit0, stepsz, thresh, tol, *,
            group=False, **kw):
        cuda_lasso.check_solve_rows_args(yah, gram, x0, z0, t0, done0, nit0,
                                         kw["maxiter"], kw["block_rows"],
                                         pairs=group)
        calls.append(("tma", tuple(gram.shape), group))
        g = _embedding_of_pairs(gram) if group else gram
        return cuda_lasso.solve_rows_plain(yah, g, x0, z0, t0, done0, nit0,
                                           stepsz, thresh, tol, group=group,
                                           **kw)

    def mma(yah, gram, *args, group=False, **kw):
        calls.append(("mma", tuple(gram.shape), group))
        return cuda_lasso.solve_rows_plain(yah, gram, *args, group=group,
                                           **kw)

    monkeypatch.setattr(cuda_lasso, "_runs_plain", lambda t: False)
    monkeypatch.setattr(cuda_lasso, "_solve_rows_tma", tma)
    monkeypatch.setattr(cuda_lasso, "_solve_rows_mma", mma)
    return calls


def test_routes_by_precision(routed):
    """'high' takes the TMA kernel (the complex mode with the pair Gram,
    from complex64 or from the embedding), 'highest' lasso_fista.cu; every
    route gives the twin's bits."""
    kw = dict(momentum=True, restart=True, maxiter=25)
    (yah, gram, x0, z0, t0, d0, n0), step = _batch(10, 20, 16, False)
    args = (yah, gram, x0, z0, t0, d0, n0, step, 0.05 * step, 1e-4)
    before = cuda_lasso.solve_rows.launches
    for hi_lo in (True, False):
        got = cuda_lasso.solve_rows(*args, hi_lo=hi_lo, **kw)
        ref = cuda_lasso.solve_rows_plain(*args, hi_lo=hi_lo, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert routed == [("tma", (16, 16), False), ("mma", (16, 16), False)]
    # The fake TMA route counts nothing; the mma route's wrapper counts.
    assert cuda_lasso.solve_rows.launches == before + 1

    routed.clear()
    (cy, cg, cx, cz, t0, d0, n0), step = _batch(11, 20, 6, True)
    cargs = (cy, cg, cx, cz, t0, d0, n0, step, 0.05 * step, 1e-4)
    for hi_lo in (True, False):
        got = cuda_lasso.solve_rows(*cargs, hi_lo=hi_lo, **kw)
        ref = cuda_lasso.solve_rows_plain(*cargs, hi_lo=hi_lo, **kw)
        assert got[0].dtype == torch.complex64
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
    py, pg, px, pz, pst, pth = cuda_lasso._complex_pairs(cy, cg, cx, cz, step,
                                                         0.05 * step)
    got = cuda_lasso.solve_rows(py, pg, px, pz, t0, d0, n0, pst, pth, 1e-4,
                                hi_lo=True, group=True, **kw)
    ref = cuda_lasso.solve_rows_plain(py, pg, px, pz, t0, d0, n0, pst, pth,
                                      1e-4, hi_lo=True, group=True, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert routed == [("tma", (6, 12), True), ("mma", (12, 12), True),
                      ("tma", (6, 12), True)]


def test_high_group_refuses_a_gram_that_is_not_an_embedding(routed):
    """f32 group=True at 'high' hands the kernel only the pairs at the even
    rows of the Gram it is given, so a Gram that is not ``embed_gram`` of a
    complex one, bit for bit, is refused before any launch; 'highest' reads
    the whole matrix and takes it."""
    kw = dict(momentum=True, restart=True, maxiter=5)
    (cy, cg, cx, cz, t0, d0, n0), step = _batch(14, 16, 6, True)
    py, pg, px, pz, pst, pth = cuda_lasso._complex_pairs(cy, cg, cx, cz, step,
                                                         0.05 * step)
    for bad in (pg + 0.5 * torch.eye(12),       # odd diagonal not Re g
                pg.clone().index_fill_(0, torch.tensor([1]), 0.0)):
        with pytest.raises(texc.DecompError, match="embed_gram"):
            cuda_lasso.solve_rows(py, bad, px, pz, t0, d0, n0, pst, pth,
                                  1e-4, hi_lo=True, group=True, **kw)
    assert routed == []
    cuda_lasso.solve_rows(py, pg + 0.5 * torch.eye(12), px, pz, t0, d0, n0,
                          pst, pth, 1e-4, hi_lo=False, group=True, **kw)
    assert routed == [("mma", (12, 12), True)]


def test_pair_route_matches_pallas_group_fc(routed):
    """The complex 'high' route, through the pair Gram, against the Pallas
    kernel's group_fc mode in interpret mode ([re | im] halves of a
    128-aligned Fc, padded rows done), on the same numpy inputs; the
    tolerances of test_torch_lasso_kernels.py's complex exact cases."""
    m, fc, fp = 24, 20, 128
    (yah, gram, x0, z0, t0, d0, n0), step = _batch(12, m, fc, True)
    kw = dict(momentum=True, restart=True, maxiter=150, hi_lo=True)
    got = cuda_lasso.solve_rows(yah, gram, x0, z0, t0, d0, n0, step,
                                0.05 * step, 1e-4, **kw)
    assert routed == [("tma", (fc, 2 * fc), True)]
    mp = 32

    def pad(v, r, c):
        v = np.asarray(v)
        return np.pad(v, ((0, r - v.shape[0]), (0, c - v.shape[1])))

    def halves(v):
        v = v.numpy()
        return np.concatenate([pad(v.real, mp, fp), pad(v.imag, mp, fp)],
                              axis=1).astype(np.float32)

    g = gram.numpy()
    gre, gim = pad(g.real, fp, fp), pad(g.imag, fp, fp)
    ref = pallas_fista.solve_rows(
        halves(yah), np.block([[gre, gim], [-gim, gre]]).astype(np.float32),
        halves(x0), halves(z0),
        np.pad(t0.numpy(), ((0, mp - m), (0, 0)), constant_values=1.0),
        np.pad(d0.numpy(), ((0, mp - m), (0, 0)), constant_values=1.0),
        pad(n0.numpy(), mp, 1), step, 0.05 * step, 1e-4, block_rows=16,
        interpret=True, group_fc=fp, fixed=False, **kw)
    ref = [np.asarray(r)[:m] for r in ref]
    rx = ref[0][:, :fc] + 1j * ref[0][:, fp:fp + fc]
    same = got[4][:, 0].numpy() == ref[4][:, 0]
    assert np.mean(same) >= 0.9
    assert rel_err(got[0].numpy()[same], rx[same]) < 1e-4
    assert rel_err(got[0].numpy(), rx) < 1e-3
    assert int(got[4][11, 0]) == 7 and np.array_equal(got[0][3].numpy(),
                                                      x0[3].numpy())


def test_range_checks_need_no_card():
    """The 'high' route's refusals run on CPU tensors, before any launch."""
    m, z = 4, torch.zeros
    with pytest.raises(texc.ShapeError,
                       match=r"gram must have shape \(4, 8\)"):
        cuda_lasso.check_solve_rows_args(z((m, 8)), z((8, 8)), z((m, 8)),
                                         z((m, 8)), z(m), z(m), z(m), 10,
                                         None, pairs=True)
    assert cuda_lasso.check_solve_rows_args(
        z((m, 8)), z((4, 8)), z((m, 8)), z((m, 8)), z(m), z(m), z(m), 10,
        None, pairs=True) == 32
    # The complex mode's gate: 640 complex features (1,280 reals).
    for f in (1282, 2048):
        with pytest.raises(texc.ShapeError, match="1 <= F <= 1280 reals"):
            cuda_lasso.check_solve_rows_args(
                z((m, f)), z((f // 2, f)), z((m, f)), z((m, f)), z(m), z(m),
                z(m), 10, None, pairs=True)
    with pytest.raises(texc.DecompError, match="kernel_block_rows"):
        cuda_lasso.check_solve_rows_args(
            z((m, 600)), z((300, 600)), z((m, 600)), z((m, 600)), z(m),
            z(m), z(m), 10, 32, pairs=True)
    with pytest.raises(texc.DtypeError):
        cuda_lasso.check_solve_rows_args(
            z((m, 8)), z((4, 8), dtype=torch.float64), z((m, 8)), z((m, 8)),
            z(m), z(m), z(m), 10, None, pairs=True)


def test_high_route_refusals(routed):
    """Through the 'high' route as if on the card: what the kernel does not
    take raises, and nothing is launched."""
    m = 4
    c = torch.zeros((m, 6), dtype=torch.complex64)
    g = torch.zeros((6, 6), dtype=torch.complex64)
    z = torch.zeros(m)
    kw = dict(momentum=False, restart=False, maxiter=1, hi_lo=True)
    with pytest.raises(texc.DtypeError, match="complex64 gram"):
        cuda_lasso.solve_rows(c, g.real, c, c, z, z, z, 1.0, 0.1, 0.0, **kw)
    with pytest.raises(texc.ShapeError, match="even F"):
        cuda_lasso.solve_rows(torch.zeros((m, 7)), torch.zeros((7, 7)),
                              torch.zeros((m, 7)), torch.zeros((m, 7)), z, z,
                              z, 1.0, 0.1, 0.0, group=True, **kw)
    with pytest.raises(texc.ShapeError, match="gram must have shape"):
        cuda_lasso.solve_rows(torch.zeros((m, 8)), torch.zeros((4, 8)),
                              torch.zeros((m, 8)), torch.zeros((m, 8)), z, z,
                              z, 1.0, 0.1, 0.0, group=True, **kw)
    with pytest.raises(ValueError, match="maxiter"):
        cuda_lasso.solve_rows(c, g, c, c, z, z, z, 1.0, 0.1, 0.0,
                              **{**kw, "maxiter": -1})
    assert routed == []


@pytest.fixture
def fake_launch(monkeypatch):
    """The kernels' launchers on CPU tensors, as far as the C call: each
    call's arguments (the stream appended) checked against the declared
    ctypes signature, recorded, and not run."""
    import contextlib
    import ctypes
    from types import SimpleNamespace

    calls = []

    def c_function(source, name, argtypes):
        return SimpleNamespace(source=source, name=name, argtypes=argtypes)

    def launch(name, fn, device, *args):
        args = args + (0,)   # the stream
        assert len(args) == len(fn.argtypes), (fn.name, len(args))
        for a, t in zip(args, fn.argtypes):
            assert isinstance(a, float if t is ctypes.c_float else int)
        calls.append((fn.source, args))

    monkeypatch.setattr(cuda_lasso, "_c_function", c_function)
    monkeypatch.setattr(cuda_lasso, "_launch", launch)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: SimpleNamespace(multi_processor_count=132))
    return calls


@pytest.mark.parametrize("complex_", [False, True])
def test_launch_arguments_match_the_c_signatures(fake_launch, complex_):
    """Both launchers pass what their C entry points declare: the TMA
    kernel one block per SM at most and its stage images (of the pair Gram
    in the complex mode); lasso_fista.cu its 'high' halves."""
    m, f = 40, 10
    (yah, gram, x0, z0, t0, d0, n0), step = _batch(13, m, f, complex_)
    kw = dict(momentum=True, restart=True, maxiter=9)
    before = (cuda_lasso.solve_rows.launches,
              cuda_lasso.solve_rows.tma_launches)
    cuda_lasso._solve_rows_tma(
        *((cuda_lasso.as_pairs(yah), cuda_lasso.pair_gram(gram),
           cuda_lasso.as_pairs(x0), cuda_lasso.as_pairs(z0))
          if complex_ else (yah, gram, x0, z0)),
        t0, d0, n0, step, 0.05 * step, 1e-4, group=complex_, **kw)
    cuda_lasso._solve_rows_mma(yah, gram, x0, z0, t0, d0, n0, step,
                               0.05 * step, 1e-4, **kw)
    assert cuda_lasso.solve_rows.tma_launches == before[1] + 1
    # The mma launcher counts nothing.
    assert cuda_lasso.solve_rows.launches == before[0] + 1
    assert cuda_lasso.solve_rows.slot_iters.shape == (2,)
    (src_t, a_t), (src_m, a_m) = fake_launch
    assert (src_t, src_m) == ("lasso_fista_tma", "lasso_fista")
    reals = 2 * f if complex_ else f
    # momentum, restart, fixed, group, rows, blocks; ...; M, F, maxiter
    assert a_t[:6] == (1, 1, 0, int(complex_), 32, 2)
    assert a_t[16:19] == (m, reals, 9)
    assert a_m[:6] == (1, 1, 1, 0, int(complex_), 32)
