"""The package surface of the PyTorch port against ``decomp_tpu``'s: every
name that ``decomp_tpu.__all__`` and ``decomp_tpu.utils.__all__`` export
exists at the same level of ``decomp_tpu_torch``, and is of the same kind
(a module for a module, a class for a class, a function for a function),
except the names that ROADMAP.md lists under "Do not port"."""

import inspect

import pytest

import decomp_tpu
import decomp_tpu.utils
import decomp_tpu_torch
import decomp_tpu_torch.utils

# ROADMAP.md, "Do not port": the names among them that a package-level
# __all__ could hold. None of them is in either list today.
DO_NOT_PORT = {"complex_split", "weakcache", "epoch_cache_info",
               "LoaderKeyedCache", "calibrated_tpu"}

SURFACE = [(decomp_tpu, decomp_tpu_torch, name)
           for name in decomp_tpu.__all__] + [
    (decomp_tpu.utils, decomp_tpu_torch.utils, name)
    for name in decomp_tpu.utils.__all__]


def _kind(obj):
    for kind, test in (("module", inspect.ismodule),
                       ("class", inspect.isclass),
                       ("function", callable)):
        if test(obj):
            return kind
    return type(obj).__name__


@pytest.mark.parametrize("ref,port,name", [
    s for s in SURFACE if s[2] not in DO_NOT_PORT],
    ids=[f"{s[0].__name__}.{s[2]}" for s in SURFACE
         if s[2] not in DO_NOT_PORT])
def test_name_is_exported_by_the_port(ref, port, name):
    assert name in port.__all__
    assert _kind(getattr(port, name)) == _kind(getattr(ref, name))


def test_the_surface_gaps_are_closed():
    from decomp_tpu_torch.utils import aot, checkpoint, result

    assert decomp_tpu_torch.SplitComplex is result.SplitComplex
    assert decomp_tpu_torch.SplitComplex._fields == ("re", "im")
    assert (decomp_tpu_torch.utils.CheckpointManager
            is checkpoint.CheckpointManager)
    assert (decomp_tpu_torch.utils.checkpointed_solve
            is checkpoint.checkpointed_solve)
    assert decomp_tpu_torch.utils.aot is aot
    for name in ("export_solver", "load_solver", "AotSolver"):
        assert hasattr(aot, name)
