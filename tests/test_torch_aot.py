"""Solver artifacts of the PyTorch port (``decomp_tpu_torch.utils.aot``) on
CPU tensors: the ten cases of ``tests/test_aot.py`` ported, each round
trip (export, ``serialize``, ``load_solver``, call) equal to the live port
solve bit for bit (x, d, niter, converged); the port's artifacts held to
``decomp_tpu``'s artifacts on the same numpy inputs and explicit starts;
and what only the port has: its own format, the pin's refusals, and the
built libraries that an artifact carries and ``ops._build.install`` puts
in place (fake bytes under a temporary ``_build.BUILD_DIR``: the CPU
tests build no kernel).

The port's ``lasso.solve`` takes ``mask`` by keyword only, and the port
refuses wrappers (a closure cannot be named in another process), so where
the reference passes a request-time mask through a wrapper, the port
bakes it into the artifact as a constant."""

import functools
import hashlib
import json

import numpy as np
import pytest
import torch

import decomp_tpu
import decomp_tpu_torch as dt
import torch_parallel_ranks as ranks
from decomp_tpu.utils import aot as jaot
from decomp_tpu_torch.ops import _build, cuda_mu
from decomp_tpu_torch.utils import aot, normalize
from decomp_tpu_torch.utils.exceptions import DecompError
from problems import (planted_lasso, planted_nmf, planted_patches,
                      random_mask, rel_err)
from torch_parallel_ranks import assemble, worlds  # noqa: F401


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _equal(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, dt.SplitComplex):
        return _equal(a.re, b.re) and _equal(a.im, b.im)
    return a == b


def _assert_same(res, live):
    """Bit for bit: x, d (where the family has it), niter, converged."""
    assert type(res) is type(live)
    for field in ("x", "d", "niter", "converged"):
        if hasattr(live, field):
            assert _equal(getattr(res, field), getattr(live, field)), field


def _roundtrip(solve_fn, *args, **kw):
    return aot.load_solver(aot.export_solver(solve_fn, *args,
                                             **kw).serialize())


# --- the ten cases of tests/test_aot.py -----------------------------------

def test_aot_nmf_roundtrip(tmp_path):
    y, *_ = planted_nmf(seed=1, n_samples=48, n_channels=24, rank=3)
    rng = np.random.default_rng(2)
    y, d0 = _t(y), _t(rng.uniform(0.1, 1.0, (3, 24)))
    cfg = dict(tol=1e-5, maxiter=200, random_seed=0)

    live = dt.nmf.solve(y, d0, **cfg)
    art = aot.export_solver(dt.nmf.solve, y, d0, **cfg)
    path = tmp_path / "nmf.dttaot"
    art.save(path)
    loaded = aot.load_solver(path)

    res = loaded(y, d0)
    assert isinstance(res, dt.NMFResult)
    _assert_same(res, live)
    # the call contract is pinned and inspectable
    assert loaded.in_avals[0].shape == y.shape
    assert loaded.in_avals[0].dtype == torch.float64
    assert loaded.platforms == ("cpu",) and loaded.libraries == ()


def test_aot_lasso_per_problem_masked_roundtrip():
    y, a, _ = planted_lasso(seed=3, n_samples=24, n_features=12,
                            n_channels=16)
    mask = random_mask(4, y.shape)
    ym, a, mask = _t(y * mask), _t(a), _t(mask)
    cfg = dict(mask=mask, tol=1e-5, maxiter=150, method="acc_ista",
               per_problem=True)

    live = dt.lasso.solve(ym, a, 0.1, **cfg)
    loaded = _roundtrip(dt.lasso.solve, ym, a, 0.1, **cfg)
    res = loaded(ym, a, 0.1)
    assert isinstance(res, dt.LassoResult)
    assert res.niter.shape == (24,) and len(set(res.niter.tolist())) > 1
    _assert_same(res, live)


def test_aot_dictionary_learning_roundtrip():
    y, d_true, _ = planted_patches(seed=5, n_samples=40)
    rng = np.random.default_rng(6)
    y, d0 = _t(y), _t(d_true + 0.3 * rng.normal(size=d_true.shape))
    cfg = dict(tol=0.0, maxiter=5, lasso_iter=4, lasso_tol=0.0)

    live = dt.dictionary_learning.solve(y, d0, 0.05, **cfg)
    loaded = _roundtrip(dt.dictionary_learning.solve, y, d0, 0.05, **cfg)
    res = loaded(y, d0, 0.05)
    assert isinstance(res, dt.DictionaryLearningResult)
    _assert_same(res, live)


def test_aot_masked_completion_preset_roundtrip():
    """The preset returns aux (held-out error), which must survive."""
    y, *_ = planted_nmf(seed=7, n_samples=64, n_channels=32, rank=3)
    mask = random_mask(8, y.shape)
    ym, mask = _t(y * mask), _t(mask)
    cfg = dict(rank=3, tol=1e-3, maxiter=400, random_seed=1, mixed=False)

    live = dt.nmf.masked_completion(ym, mask, **cfg)
    loaded = _roundtrip(dt.nmf.masked_completion, ym, mask, **cfg)
    res = loaded(ym, mask)
    _assert_same(res, live)
    assert res.aux is not None and "heldout_rel_err" in res.aux
    assert _equal(res.aux["heldout_rel_err"], live.aux["heldout_rel_err"])


def test_aot_meta_specs_and_baked_partial():
    """Export from specs alone (meta tensors, no example data), with the
    dictionary baked into the artifact through a functools.partial."""
    y, a, _ = planted_lasso(seed=9, n_samples=16, n_features=8,
                            n_channels=12)
    y, a = _t(y), _t(a)
    entry = functools.partial(dt.lasso.solve, a=a, alpha=0.1, tol=1e-5,
                              maxiter=100, method="fista")

    live = entry(y)
    spec = torch.empty(y.shape, dtype=torch.float64, device="meta")
    loaded = _roundtrip(entry, spec, platforms=("cpu",))
    res = loaded(y)
    _assert_same(res, live)
    assert loaded.libraries == ()


def test_aot_split_complex_roundtrip():
    """solve_split artifacts carry SplitComplex pairs in the inputs and in
    the result's x."""
    rng = np.random.default_rng(13)
    m, f, c = 16, 8, 12
    a = (rng.normal(size=(f, c))
         + 1j * rng.normal(size=(f, c))).astype(np.complex64)
    y = (rng.normal(size=(m, c))
         + 1j * rng.normal(size=(m, c))).astype(np.complex64)
    ys = dt.SplitComplex(_t(y.real), _t(y.imag))
    a_s = dt.SplitComplex(_t(a.real), _t(a.imag))
    cfg = dict(tol=1e-5, maxiter=60, method="fista")

    live = dt.lasso.solve_split(ys, a_s, 0.1, **cfg)
    loaded = _roundtrip(dt.lasso.solve_split, ys, a_s, 0.1, **cfg)
    assert isinstance(loaded.in_avals[0], dt.SplitComplex)
    res = loaded(ys, a_s, 0.1)
    assert isinstance(res.x, dt.SplitComplex)
    _assert_same(res, live)


def _sharded_problem(seed, m):
    rng = np.random.default_rng(seed)
    return dict(y=rng.uniform(0.1, 1.0, (m, 32)),
                d=rng.uniform(0.1, 1.0, (4, 32)))


def test_aot_sharded_solve_roundtrip(worlds):
    """A parallel solve exports on every rank of a gloo world of 2 and its
    artifact reproduces the live sharded solve; the artifact pins the
    rank's block (64 global rows, 32 a rank)."""
    arrays = _sharded_problem(11, 64)
    outs = worlds(2).run(ranks.aot_nmf, ((2,), ("rows",)), "rows", arrays,
                         dict(tol=0.0, maxiter=12))
    for o in outs:
        assert o["same"] == [True] * 4
        assert o["pinned"] == (32, 32)
    assert assemble(outs).shape == (64, 4)


def test_aot_multislice_tuple_axis_roundtrip(worlds):
    """A ('slice', 'rows') tuple axis on make_multislice_mesh in a world of
    4: the artifact pins the mesh's layout and names and the tuple
    row_axis, and rebuilds the mesh in the caller's world."""
    arrays = _sharded_problem(17, 64)
    outs = worlds(4).run(ranks.aot_nmf, "multislice", ("slice", "rows"),
                         arrays, dict(tol=1e-5, maxiter=40))
    for o in outs:
        assert o["same"] == [True] * 4
        assert o["pinned"] == (16, 32)
    header = json.loads(outs[0]["blob"].split(b"\n")[1])
    assert header["kwargs"]["row_axis"] == {"tuple": ["slice", "rows"]}
    assert header["kwargs"]["mesh"] == {"mesh": {
        "layout": [[0, 1], [2, 3]], "names": ["slice", "rows"]}}


def test_aot_multi_platform_artifact():
    """platforms=('cpu', 'cuda') makes one artifact for both; called on
    the CPU it reproduces the live solve."""
    y, *_ = planted_nmf(seed=15, n_samples=32, n_channels=16, rank=3)
    rng = np.random.default_rng(16)
    y, d0 = _t(y), _t(rng.uniform(0.1, 1.0, (3, 16)))
    cfg = dict(tol=0.0, maxiter=10)

    live = dt.nmf.solve(y, d0, **cfg)
    loaded = _roundtrip(dt.nmf.solve, y, d0, platforms=("cpu", "cuda"),
                        **cfg)
    assert set(loaded.platforms) == {"cpu", "cuda"}
    _assert_same(loaded(y, d0), live)


def test_aot_rejects_garbage_and_non_result_functions(tmp_path):
    with pytest.raises(DecompError, match="bad magic"):
        aot.load_solver(b"not an artifact")
    p = tmp_path / "junk.bin"
    p.write_bytes(b"DTTAOT1\n{\"result_cls\": \"nope\"}\n")
    with pytest.raises(DecompError, match="unknown result class"):
        aot.load_solver(p)
    p.write_bytes(b"DTTAOT1\n{\"result_cls\": \"NMFResult\"}\n")
    with pytest.raises(DecompError, match="corrupt AOT artifact header"):
        aot.load_solver(p)
    p.write_bytes(b"DTTAOT1\n{not json\n")
    with pytest.raises(DecompError, match="corrupt AOT artifact header"):
        aot.load_solver(p)
    with pytest.raises(DecompError, match="Result pytree"):
        aot.export_solver(normalize.l2_norm, torch.ones((3, 3)))


# --- the port against decomp_tpu's artifacts --------------------------------

def _nmf_case():
    y, *_ = planted_nmf(seed=21, n_samples=48, n_channels=24, rank=3)
    rng = np.random.default_rng(22)
    d0, x0 = rng.uniform(0.1, 1.0, (3, 24)), rng.uniform(0.1, 1.0, (48, 3))
    return ((decomp_tpu.nmf.solve, dt.nmf.solve), (y, d0),
            dict(x=x0, tol=1e-5, maxiter=200))


def _lasso_case():
    y, a, _ = planted_lasso(seed=23, n_samples=24, n_features=12,
                            n_channels=16)
    mask = random_mask(24, y.shape)
    return ((decomp_tpu.lasso.solve, dt.lasso.solve), (y * mask, a, 0.1),
            dict(mask=mask, tol=1e-6, maxiter=300, method="acc_ista",
                 per_problem=True))


def _dl_case():
    y, d_true, _ = planted_patches(seed=25, n_samples=40)
    rng = np.random.default_rng(26)
    d0 = d_true + 0.3 * rng.normal(size=d_true.shape)
    return ((decomp_tpu.dictionary_learning.solve,
             dt.dictionary_learning.solve), (y, d0, 0.05),
            dict(tol=1e-4, maxiter=20, lasso_iter=8, lasso_tol=0.0))


# f64 compositions on both sides (decomp_tpu's 'auto' takes no Pallas
# kernel on the CPU, the port's none on CPU tensors): the families' parity
# tolerance of their live-solve tests (tests/test_torch_nmf.py,
# test_torch_lasso.py, test_torch_dl.py), 1e-10 relative with equal niter.
@pytest.mark.parametrize("case", [_nmf_case, _lasso_case, _dl_case],
                         ids=["nmf", "lasso", "dictionary_learning"])
def test_aot_matches_jax_artifact(case):
    (jfn, tfn), args, kw = case()
    jres = jaot.load_solver(jaot.export_solver(jfn, *args,
                                               **kw).serialize())(*args)
    targs = [_t(a) if isinstance(a, np.ndarray) else a for a in args]
    tkw = {k: _t(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    tres = _roundtrip(tfn, *targs, **tkw)(*targs)
    _assert_same(tres, tfn(*targs, **tkw))
    np.testing.assert_array_equal(np.asarray(tres.niter),
                                  np.asarray(jres.niter))
    np.testing.assert_array_equal(np.asarray(tres.converged),
                                  np.asarray(jres.converged))
    assert rel_err(tres.x.numpy(), jres.x) < 1e-10
    if hasattr(tres, "d"):
        assert rel_err(tres.d.numpy(), jres.d) < 1e-10


def test_formats_refuse_each_other():
    (jfn, tfn), args, kw = _nmf_case()
    jbytes = jaot.export_solver(jfn, *args, **kw).serialize()
    tbytes = aot.export_solver(tfn, *map(_t, args),
                               **{**kw, "x": _t(kw["x"])}).serialize()
    with pytest.raises(DecompError, match="bad magic"):
        aot.load_solver(jbytes)
    with pytest.raises(decomp_tpu.utils.DecompError, match="bad magic"):
        jaot.load_solver(tbytes)


# --- the pin and the solve -------------------------------------------------

def _nmf_artifact(**kw):
    y, *_ = planted_nmf(seed=31, n_samples=20, n_channels=12, rank=2)
    d0 = np.random.default_rng(32).uniform(0.1, 1.0, (2, 12))
    y, d0 = _t(y), _t(d0)
    return y, d0, _roundtrip(dt.nmf.solve, y, d0, tol=0.0, maxiter=3, **kw)


@pytest.mark.parametrize("bad", ["shape", "dtype", "platform", "kind",
                                 "count"])
def test_a_call_off_the_pin_is_refused(bad):
    y, d0, loaded = _nmf_artifact()
    args = {"shape": (y[:-1], d0), "dtype": (y.float(), d0),
            "platform": (y.to("meta"), d0), "kind": (y.numpy(), d0),
            "count": (y,)}[bad]
    with pytest.raises(DecompError, match="AOT"):
        loaded(*args)


def test_a_cuda_artifact_without_a_card_raises():
    """platforms=None for specs alone means 'cuda', the port's default
    device; a call with CPU tensors is off the pin, never run on the
    CPU instead."""
    y, d0, _ = _nmf_artifact()
    art = aot.export_solver(dt.nmf.solve, y.to("meta"), d0.to("meta"),
                            tol=0.0, maxiter=3)
    assert art.platforms == ("cuda",)
    with pytest.raises(DecompError, match=r"on \('cuda',\)"):
        aot.load_solver(art.serialize())(y, d0)


def _local():
    return dt.nmf.solve


@pytest.mark.parametrize("fn", [
    lambda y, d: dt.nmf.solve(y, d),
    "closure",
    decomp_tpu.nmf.solve,
    "private",
], ids=["lambda", "closure", "other_package", "private"])
def test_unnameable_solves_are_refused(fn):
    if fn == "closure":
        def fn(y, d):
            return dt.nmf.solve(y, d)
    elif fn == "private":
        from decomp_tpu_torch.models import nmf as tnmf
        fn = tnmf._solve
    y, d0, _ = _nmf_artifact()
    with pytest.raises(DecompError, match="not a public solve"):
        aot.export_solver(fn, y, d0)


@pytest.mark.parametrize("kw,match", [
    (dict(platforms=("tpu",)), "platforms"),
    (dict(platforms=("cpu", "cpu")), "platforms"),
    (dict(verbose=lambda: None), "cannot bake"),
])
def test_bad_export_arguments_are_refused(kw, match):
    y, d0, _ = _nmf_artifact()
    with pytest.raises(DecompError, match=match):
        aot.export_solver(dt.nmf.solve, y, d0, tol=0.0, maxiter=3, **kw)


def test_baked_configuration_round_trips():
    """dtypes, bf16 tensors, tuples and a factor dtype survive the header
    and the savez constants bit for bit."""
    y, d0, _ = _nmf_artifact()
    yb = y.to(torch.bfloat16)
    x0 = torch.rand((y.shape[0], 2), generator=torch.Generator().manual_seed(
        3)).to(torch.bfloat16)
    kw = dict(x=x0, tol=0.0, maxiter=3, factor_dtype=torch.float32)
    live = dt.nmf.solve(yb, d0.to(torch.bfloat16), **kw)
    res = _roundtrip(dt.nmf.solve, yb, d0.to(torch.bfloat16),
                     **kw)(yb, d0.to(torch.bfloat16))
    assert res.x.dtype == torch.float32
    _assert_same(res, live)


def test_rank_blocks_are_pinned_and_worlds_must_match(worlds):
    """With 66 global rows (33 a rank, not divisible by the world of 2)
    the pin is the rank's (33, 32), and the global y is off it. The
    artifact of a world of 2 refuses a world of 4 and a process without
    a process group."""
    arrays = _sharded_problem(41, 66)
    outs = worlds(2).run(ranks.aot_nmf, ((2,), ("rows",)), "rows", arrays,
                         dict(tol=0.0, maxiter=5))
    for o in outs:
        assert o["same"] == [True] * 4
        assert o["pinned"] == (33, 32)
        assert "pinned to shape (33, 32)" in o["global_refusal"]
    blob, y0, d = outs[0]["blob"], arrays["y"][:33], arrays["d"]
    for err in worlds(4).run(ranks.aot_call, blob, y0, d):
        assert err[0] == "DecompError"
        assert "exported for 2 ranks" in err[1] and "world of 4" in err[1]
    with pytest.raises(DecompError, match="outside a process group"):
        aot.load_solver(blob)(_t(y0), _t(d))


@pytest.mark.parametrize("module,qualname", [
    ("decomp_tpu_torch.models.nmf", "_solve"),
    ("decomp_tpu_torch.ops._build", "install"),
    ("os", "system"),
    ("decomp_tpu_torch.models.nmf", "no_such_solve"),
])
def test_load_solver_names_only_public_solves(module, qualname):
    """A header is outside input: it may name a public solve of the
    package and nothing else."""
    _, _, art = _nmf_artifact()
    blob = art.serialize()
    header = json.loads(blob.split(b"\n")[1])
    header.update(module=module, qualname=qualname)
    forged = b"\n".join([b"DTTAOT1", json.dumps(header).encode(),
                         blob.split(b"\n", 2)[2]])
    with pytest.raises(DecompError, match="no solve of decomp_tpu_torch"):
        aot.load_solver(forged)


def test_truncated_payload_is_refused():
    _, _, art = _nmf_artifact()
    with pytest.raises(DecompError, match="corrupt AOT artifact payload"):
        aot.load_solver(art.serialize()[:-1])


# --- the carried libraries ---------------------------------------------------

def _fake_library(name="mu_dense_tma", blob=b"\x7fELF not a real library"):
    return _build.library_path(name).name, blob, hashlib.sha256(
        blob).hexdigest()


@pytest.fixture
def build_dir(tmp_path, monkeypatch):
    d = tmp_path / "_build"
    monkeypatch.setattr(_build, "BUILD_DIR", d)
    return d


def test_install_puts_a_library_where_build_finds_it(build_dir):
    name, blob, digest = _fake_library()
    out = _build.install(name, blob, digest)
    assert out == _build.library_path("mu_dense_tma")
    assert out.read_bytes() == blob
    assert [p.name for p in build_dir.iterdir()] == [name]
    # build() finds it and runs no nvcc
    assert _build.build("mu_dense_tma") == out
    # a library of that name is already built: kept
    assert _build.install(name, b"other", hashlib.sha256(
        b"other").hexdigest()).read_bytes() == blob


@pytest.mark.parametrize("bad,match", [
    ("digest", "sha256"),
    ("hash", "other sources, headers or flags"),
    ("source", "not built from a source"),
    ("name", "not built from a source"),
])
def test_install_refuses(build_dir, bad, match):
    name, blob, digest = _fake_library()
    if bad == "digest":
        digest = hashlib.sha256(b"other").hexdigest()
    elif bad == "hash":
        name = "libmu_dense_tma-0123456789abcdef.so"
    elif bad == "source":
        name = "libno_such_kernel-0123456789abcdef.so"
    else:
        name = "../" + name
    with pytest.raises(DecompError, match=match):
        _build.install(name, blob, digest)
    assert not build_dir.exists() or not any(build_dir.iterdir())


def _with_library(art, name, blob, digest, capability=(9, 0)):
    """``art``'s bytes with a carried library entry."""
    header = dict(art._header, platforms=["cuda"],
                  capability=list(capability),
                  libraries=[{"file": name, "sha256": digest,
                              "bytes": len(blob)}])
    return aot.AotSolver(header, art._constants, [blob]).serialize()


def test_load_solver_installs_the_carried_libraries(build_dir):
    y, d0, art = _nmf_artifact()
    name, blob, digest = _fake_library()
    loaded = aot.load_solver(_with_library(art, name, blob, digest))
    assert loaded.libraries == (name,)
    assert (build_dir / name).read_bytes() == blob
    assert sorted(p.name for p in build_dir.iterdir()) == [name]


@pytest.mark.parametrize("bad,match", [
    ("sources", "other sources, headers or flags"),
    ("digest", "sha256"),
    ("built_for", r"capability \(8, 0\)"),
    ("card", r"this card has \(8, 6\)"),
])
def test_load_solver_refuses_foreign_libraries(build_dir, monkeypatch, bad,
                                               match):
    _, _, art = _nmf_artifact()
    name, blob, digest = _fake_library()
    cap = (9, 0)
    if bad == "sources":
        name = "libmu_dense_tma-0123456789abcdef.so"
    elif bad == "digest":
        blob = blob + b"!"
    elif bad == "built_for":
        cap = (8, 0)
    else:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "get_device_capability",
                            lambda *a: (8, 6))
    with pytest.raises(DecompError, match=match):
        aot.load_solver(_with_library(art, name, blob, digest, cap))
    assert not build_dir.exists() or not any(build_dir.iterdir())


def test_record_sees_a_library_loaded_before_the_export(build_dir,
                                                        monkeypatch,
                                                        tmp_path):
    """The library of a launch is recorded at every launch, also when its
    entry point was loaded (and cached) before the export: a twin that
    asks for its kernel's entry point as a launch on the card does stands
    in for the launch. The artifact carries the library's bytes, and a
    process with an empty _build/ gets them from load_solver."""
    name, blob, _ = _fake_library()
    (build_dir).mkdir()
    (build_dir / name).write_bytes(blob)
    loads = []

    class Entry:
        pass

    def load(source):
        loads.append(source)
        return type("Lib", (), {"mu_dense_tma_launch": Entry()})()

    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(cuda_mu, "_c_entry",
                        functools.cache(cuda_mu._c_entry.__wrapped__))
    cuda_mu._c_function("mu_dense_tma", "mu_dense_tma_launch", ())
    assert loads == ["mu_dense_tma"]
    plain = cuda_mu.mu_stats_dense_plain

    def twin(*a, **k):
        cuda_mu._c_function("mu_dense_tma", "mu_dense_tma_launch", ())
        return plain(*a, **k)

    monkeypatch.setattr(cuda_mu, "mu_stats_dense_plain", twin)
    y, d0, _ = _nmf_artifact()
    art = aot.export_solver(dt.nmf.solve, y, d0, tol=0.0, maxiter=3,
                            use_kernel=True)
    assert loads == ["mu_dense_tma"]          # cached: loaded once
    assert art.libraries == (name,)
    with _build.recording() as seen:
        pass
    assert seen == set()                      # nothing outside the export
    fresh = tmp_path / "fresh_build"
    monkeypatch.setattr(_build, "BUILD_DIR", fresh)
    loaded = aot.load_solver(art.serialize())
    assert (fresh / name).read_bytes() == blob
    _assert_same(loaded(y, d0), dt.nmf.solve(y, d0, tol=0.0, maxiter=3,
                                             use_kernel=True))
