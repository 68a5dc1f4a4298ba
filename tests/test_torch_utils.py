"""Base layer of the PyTorch port against ``decomp_tpu``'s: exceptions,
dtype helpers, assertions, normalisation, results, the numpy bridge, the
kernel build's bookkeeping, and the package's independence from JAX.
Inputs are made with numpy from a seed and go through both packages."""

import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import decomp_tpu
from decomp_tpu.utils import assertion as jassert
from decomp_tpu.utils import exceptions as jexc
from decomp_tpu.utils import normalize as jnorm
from decomp_tpu.utils import result as jresult
from decomp_tpu_torch.ops import _build
from decomp_tpu_torch.utils import assertion as tassert
from decomp_tpu_torch.utils import convert, dtypes
from decomp_tpu_torch.utils import exceptions as texc
from decomp_tpu_torch.utils import normalize as tnorm
from decomp_tpu_torch.utils import result as tresult

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", ["DecompError", "ShapeError", "DtypeError"])
def test_exception_hierarchy_matches(name):
    jcls, tcls = getattr(jexc, name), getattr(texc, name)
    assert [c.__name__ for c in jcls.__mro__] == [
        c.__name__ for c in tcls.__mro__]


@pytest.mark.parametrize("dtype,real", [
    (torch.float32, torch.float32), (torch.float64, torch.float64),
    (torch.bfloat16, torch.bfloat16), (torch.complex64, torch.float32),
    (torch.complex128, torch.float64)])
def test_real_dtype(dtype, real):
    assert dtypes.real_dtype(dtype) == real


@pytest.mark.parametrize("dtype,acc", [
    (torch.bfloat16, torch.float32), (torch.float32, torch.float32),
    (torch.float64, torch.float64), (torch.complex64, torch.float32)])
def test_acc_dtype(dtype, acc):
    assert dtypes.acc_dtype(dtype) == acc


def test_dtype_helpers():
    assert dtypes.is_complex(torch.zeros(2, dtype=torch.complex64))
    assert not dtypes.is_complex(torch.float32)
    a = torch.zeros(2, dtype=torch.float32)
    b = torch.zeros(2, dtype=torch.complex128)
    assert dtypes.result_real_dtype(a, b) == torch.float64
    e = dtypes.eps_for(torch.complex64, 2.0)
    assert e.dtype == torch.float32
    assert float(e) == pytest.approx(2 * np.finfo(np.float32).eps)


@pytest.mark.parametrize("check,args,exc", [
    ("assert_ndim", ("y", np.zeros((2, 3, 4)), 2), "ShapeError"),
    ("assert_axis_size", ("d", np.zeros((2, 3)), 1, 4, "n"), "ShapeError"),
    ("assert_same_shape", ("a", np.zeros((2, 3)), "b", np.zeros((3, 2))),
     "ShapeError"),
    ("assert_inexact", ("y", np.zeros(3, np.int32)), "DtypeError"),
    ("assert_real", ("y", np.zeros(3, np.complex64)), "DtypeError"),
    ("assert_nonnegative", ("alpha", np.array([-1.0])), "DtypeError"),
])
def test_assertions_raise_like_jax(check, args, exc):
    targs = tuple(torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                  for a in args)
    with pytest.raises(getattr(jexc, exc)):
        getattr(jassert, check)(*args)
    with pytest.raises(getattr(texc, exc)):
        getattr(tassert, check)(*targs)


def test_assertions_pass_on_good_input():
    y = torch.zeros((2, 3))
    tassert.assert_ndim("y", y, (1, 2))
    tassert.assert_axis_size("y", y, 1, 3, "n")
    tassert.assert_same_shape("y", y, "z", torch.ones((2, 3)))
    tassert.assert_inexact("y", y)
    tassert.assert_real("y", y)
    tassert.assert_nonnegative("alpha", 0.0)


@pytest.mark.parametrize("axis", [None, 0, 1])
def test_l2_norm_parity(axis):
    rng = np.random.default_rng(0)
    a = rng.normal(size=(5, 7)) + 1j * rng.normal(size=(5, 7))
    for arr in (a.real, a):
        ref = np.asarray(jnorm.l2_norm(jnp.asarray(arr), axis=axis,
                                       keepdims=True))
        got = tnorm.l2_norm(torch.from_numpy(arr), axis=axis, keepdims=True)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-13)


def test_l2_normalize_parity_and_zero_rows():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(4, 6))
    a[2] = 0.0
    ref = np.asarray(jnorm.l2_normalize(jnp.asarray(a)))
    got = tnorm.l2_normalize(torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-13)
    assert np.all(got[2] == 0.0)


@pytest.mark.parametrize("name", ["NMFResult", "LassoResult",
                                  "DictionaryLearningResult"])
def test_result_fields_match(name):
    assert getattr(tresult, name)._fields == getattr(jresult, name)._fields


def test_from_numpy_takes_jax_nmf_result():
    rng = np.random.default_rng(2)
    y = rng.uniform(size=(12, 8))
    res = decomp_tpu.nmf.solve(y, rank=3, maxiter=4, tol=0.0)
    tres = convert.from_numpy(res, "cpu")
    assert isinstance(tres, tresult.NMFResult)
    assert tres.x.dtype == torch.float64
    np.testing.assert_array_equal(tres.x.numpy(), np.asarray(res.x))
    np.testing.assert_array_equal(tres.d.numpy(), np.asarray(res.d))
    assert int(tres.niter) == 4 and tres.aux is None
    f32 = convert.from_numpy(res, "cpu", dtype=torch.float32)
    assert f32.d.dtype == torch.float32
    assert not f32.niter.dtype.is_floating_point  # ints keep their dtype


def test_from_numpy_bare_tuple_and_bf16_roundtrip():
    rng = np.random.default_rng(3)
    x = rng.uniform(size=(5, 2))
    d_bf = np.asarray(jnp.asarray(rng.uniform(size=(2, 7)), jnp.bfloat16))
    tx, td = convert.from_numpy((x, d_bf), "cpu")
    assert td.dtype == torch.bfloat16
    np.testing.assert_array_equal(td.float().numpy(),
                                  d_bf.astype(np.float32))
    back = convert.to_numpy({"x": tx, "d": td, "k": 3, "none": None})
    np.testing.assert_array_equal(back["x"], x)
    assert back["d"].dtype == np.float32 and back["k"] == 3
    assert back["none"] is None


def test_to_numpy_keeps_port_result_type():
    r = tresult.NMFResult(torch.ones(2, 1), torch.ones(1, 3), 5, True,
                          torch.zeros(0))
    back = convert.to_numpy(r)
    assert isinstance(back, tresult.NMFResult)
    assert back.niter == 5 and back.converged is True
    assert isinstance(back.x, np.ndarray)


def test_build_paths_are_content_addressed():
    """The library name carries a hash of the source and flags, inside
    the package's ignored build directory. Nothing is compiled here."""
    p = _build.library_path("mu_stats_dense")
    assert p.parent == _build.BUILD_DIR
    assert p == _build.library_path("mu_stats_dense")
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
    assert (_build.SRC_DIR / "mu_stats_dense.cu").exists()


def test_build_hash_covers_shared_headers(tmp_path, monkeypatch):
    """Every source may include the shared headers (csrc/*.cuh), so an
    edited header changes every library's name and a stale library is
    never loaded."""
    for f in _build.SRC_DIR.iterdir():
        if f.suffix in (".cu", ".cuh"):
            shutil.copy(f, tmp_path / f.name)
    monkeypatch.setattr(_build, "SRC_DIR", tmp_path)
    names = ("mu_stats_dense", "mu_kl_stats")
    before = [_build.library_path(n) for n in names]
    header = tmp_path / "nmf_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = [_build.library_path(n) for n in names]
    assert all(a != b for a, b in zip(before, after))
    assert len(set(after)) == len(names)


def test_package_never_imports_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    code = ("import decomp_tpu_torch, decomp_tpu_torch.ops._build, sys; "
            "import decomp_tpu_torch.models.nmf_streaming; "
            "import decomp_tpu_torch.models.dl_streaming; "
            "assert 'jax' not in sys.modules, 'jax imported'")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_package_sources_never_name_jax():
    pkg = os.path.join(REPO, "decomp_tpu_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                text = open(os.path.join(root, f)).read()
                assert "import jax" not in text and "from jax" not in text, f
