"""Solver artifacts for serving (counterpart of ``decomp_tpu.utils.aot``).

A serving process of this package pays, before its first solve, the
``nvcc`` build of the kernels that the solve launches (``ops/_build.py``),
and a machine without the CUDA toolkit cannot build them at all. An
artifact is the port's "compile once, ship bytes":

    from decomp_tpu_torch.utils import aot
    art = aot.export_solver(decomp_tpu_torch.nmf.solve, y, d0,
                            tol=1e-4, maxiter=2000)   # runs the solve once
    art.save("nmf_1mx10k.dttaot")

    # ... in a serving process on a card of the same capability, with
    # decomp_tpu_torch importable and no nvcc:
    art = aot.load_solver("nmf_1mx10k.dttaot")   # installs the libraries
    res = art(y, d0)                               # NMFResult

What an artifact carries:
- the solve: the module and qualified name of a public solve of
  ``decomp_tpu_torch`` (or of the one that a ``functools.partial``
  wraps); lambdas, closures and functions of other packages are refused;
- the pin (the call contract): each positional input's kind, shape and
  dtype, and the platforms ('cpu', 'cuda') that the call's tensors may
  lie on;
- the baked configuration: the keywords and a partial's arguments.
  Tensors and numpy arrays among them are stored as ``np.savez`` bytes,
  read back without pickle; a ``SplitComplex`` as its two parts; a
  ``DeviceMesh`` as its layout and dim names;
- for a 'cuda' artifact, the built ``sm_90a`` libraries that the export's
  run of the solve launched (``ops._build.recording``), each under its
  ``library_path`` file name (a hash of the sources, headers and flags)
  with its sha256, and the capability that they run on, (9, 0).

What it does not carry: a traced or compiled program. The solves launch
their kernels through ``ctypes`` and read the host in their stop tests,
so neither ``torch.export`` nor TorchScript captures them. A call checks
its inputs against the pin and runs the named solve of the
``decomp_tpu_torch`` that the serving process imports, with the baked
configuration; ``load_solver`` first installs the carried libraries
(``ops._build.install``) where that solve finds them, so the first call
compiles nothing. A library whose digest, name (built from sources,
headers or flags other than the local package's) or capability (not the
card's) does not match is refused, never replaced by a plain twin.

Which libraries: exactly those that the export's run launched. A route
that depends on values and not on the pin is carried only if the
export's data took it: a 0/1 mask takes the packed masked kernels, a
weighted one ``csrc/mu_kl_stats.cu``, so export with data like the
requests'. An export from specs alone (``device='meta'`` tensors, which
stand in for ``jax.ShapeDtypeStruct``) runs nothing and carries no
library, nor does one whose run launched no kernel (a CPU export). A
call that needs a library that the artifact does not carry builds it on
first use, as a live solve does.

Sharded solves (``decomp_tpu_torch.parallel``, ``mesh=``) export too:
every rank calls ``export_solver`` with its own blocks, as it calls the
solve. The artifact pins each rank's block shapes, not the global ones
(the ranks' blocks have equal shapes by the solvers' contract), and the
mesh's layout, dim names and the ``row_axis``/``col_axis`` keywords; it
does not store the process group. A call rebuilds the mesh in the
caller's world, once per artifact and device type, and a world of
another size raises ``DecompError``.
"""

import functools
import hashlib
import importlib
import io
import json
import numbers

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from decomp_tpu_torch.ops import _build
from decomp_tpu_torch.utils import result as _result
from decomp_tpu_torch.utils.exceptions import DecompError

_MAGIC = b"DTTAOT1\n"
_PACKAGE = "decomp_tpu_torch"
_PLATFORMS = ("cpu", "cuda")
_RESULT_CLASSES = {
    "LassoResult": _result.LassoResult,
    "NMFResult": _result.NMFResult,
    "DictionaryLearningResult": _result.DictionaryLearningResult,
}


def _dtype(name):
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise DecompError(f"unknown dtype {name!r} in AOT artifact")
    return dt


def _dtype_name(dt):
    return str(dt).removeprefix("torch.")


# --- the solve --------------------------------------------------------------

def _solve_name(solve_fn):
    """(solve, module, qualname, baked positionals, baked keywords) of an
    exportable solve; refuses what no serving process can name."""
    args, kwargs = (), {}
    if isinstance(solve_fn, functools.partial):
        solve_fn, args, kwargs = (solve_fn.func, solve_fn.args,
                                  dict(solve_fn.keywords))
    module = getattr(solve_fn, "__module__", None) or ""
    qualname = getattr(solve_fn, "__qualname__", None) or ""
    if _resolve(module, qualname) is not solve_fn:
        raise DecompError(
            f"{qualname or solve_fn!r} (module {module or '?'}) is not a "
            f"public solve of {_PACKAGE}: export_solver takes one, or a "
            "functools.partial of one, never a lambda, a closure or a "
            "function of another package")
    return solve_fn, module, qualname, args, kwargs


def _resolve(module, qualname):
    """The public object ``module.qualname`` of this package, or None:
    every part of both names public, the module inside the package."""
    parts = module.split(".")
    names = parts[1:] + qualname.split(".")
    if (parts[0] != _PACKAGE or not qualname
            or any(not n.isidentifier() or n.startswith("_")
                   for n in names)):
        return None
    try:
        obj = importlib.import_module(module)
        for part in qualname.split("."):
            obj = getattr(obj, part)
    except (ImportError, AttributeError):
        return None
    return obj


def _annotated_result(solve_fn):
    """The name of the Result class that ``solve_fn``'s return annotation
    names, or None."""
    ann = getattr(solve_fn, "__annotations__", {}).get("return")
    return ann if isinstance(ann, str) else getattr(ann, "__name__", None)


# --- the pin ------------------------------------------------------------------

def _pin(a):
    """The JSON pin of one positional input: a tensor (or meta spec) by
    shape and dtype, a ``SplitComplex`` by its parts, a real number, or
    None."""
    if isinstance(a, torch.Tensor):
        return {"kind": "tensor", "shape": list(a.shape),
                "dtype": _dtype_name(a.dtype)}
    if isinstance(a, _result.SplitComplex):
        return {"kind": "split", "re": _pin(a.re), "im": _pin(a.im)}
    if isinstance(a, numbers.Real) and not isinstance(a, bool):
        return {"kind": "real"}
    if a is None:
        return {"kind": "none"}
    raise DecompError(
        f"cannot pin a {type(a).__name__} as an AOT input: pass tensors "
        "(or device='meta' specs), SplitComplex pairs of them, real "
        "numbers or None; configuration goes in the keywords")


def _spec(pin):
    """The stand-in of a pinned input (``AotSolver.in_avals``)."""
    kind = pin["kind"]
    if kind == "tensor":
        return torch.empty(pin["shape"], dtype=_dtype(pin["dtype"]),
                           device="meta")
    if kind == "split":
        return _result.SplitComplex(_spec(pin["re"]), _spec(pin["im"]))
    return numbers.Real if kind == "real" else None


def _tensors(a):
    """The tensors of a positional input."""
    if isinstance(a, torch.Tensor):
        return [a]
    if isinstance(a, _result.SplitComplex):
        return _tensors(a.re) + _tensors(a.im)
    return []


def _check(i, pin, a, platforms):
    """Refuse input ``i`` where it differs from its pin."""
    kind = pin["kind"]
    if kind == "tensor":
        ok = isinstance(a, torch.Tensor)
        got = (f"a {type(a).__name__}" if not ok else
               f"shape {tuple(a.shape)} {_dtype_name(a.dtype)} on "
               f"{a.device.type}")
        if not (ok and list(a.shape) == pin["shape"]
                and _dtype_name(a.dtype) == pin["dtype"]
                and a.device.type in platforms):
            raise DecompError(
                f"AOT input {i}: pinned to shape {tuple(pin['shape'])} "
                f"{pin['dtype']} on {platforms}, got {got}")
    elif kind == "split":
        if not isinstance(a, _result.SplitComplex):
            raise DecompError(f"AOT input {i}: pinned to a SplitComplex, "
                              f"got a {type(a).__name__}")
        _check(f"{i}.re", pin["re"], a.re, platforms)
        _check(f"{i}.im", pin["im"], a.im, platforms)
    elif kind == "real":
        if not isinstance(a, numbers.Real) or isinstance(a, bool):
            raise DecompError(f"AOT input {i}: pinned to a real number, "
                              f"got a {type(a).__name__}")
    elif a is not None:
        raise DecompError(f"AOT input {i}: pinned to None, got a "
                          f"{type(a).__name__}")


# --- the baked configuration ------------------------------------------------

def _bake(v, consts, tensors):
    """The JSON node of a baked value: a JSON scalar, or a dict of one
    tagged entry. Tensors and arrays go into ``consts`` (name -> numpy
    array), each tensor's dtype into ``tensors`` (name -> dtype name)."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, np.generic):
        return _bake(v.item(), consts, tensors)
    if isinstance(v, torch.dtype):
        return {"dtype": _dtype_name(v)}
    if isinstance(v, torch.device):
        return {"device": str(v)}
    if isinstance(v, torch.Tensor):
        if v.is_meta:
            raise DecompError("a baked tensor needs its values: a meta "
                              "spec is a positional input only")
        key = f"c{len(consts)}"
        t = v.detach().cpu()
        # numpy has no bf16: its bits travel as int16.
        consts[key] = (t.view(torch.int16) if t.dtype == torch.bfloat16
                       else t).numpy()
        tensors[key] = _dtype_name(v.dtype)
        return {"tensor": key}
    if isinstance(v, np.ndarray):
        if v.dtype.hasobject:
            raise DecompError("cannot bake an object array into an AOT "
                              "artifact")
        key = f"c{len(consts)}"
        consts[key] = v
        return {"ndarray": key}
    if isinstance(v, _result.SplitComplex):
        return {"split": [_bake(v.re, consts, tensors),
                          _bake(v.im, consts, tensors)]}
    if isinstance(v, DeviceMesh):
        return {"mesh": {"layout": v.mesh.tolist(),
                         "names": list(v.mesh_dim_names or ())}}
    if isinstance(v, (tuple, list)):
        kind = "tuple" if isinstance(v, tuple) else "list"
        return {kind: [_bake(e, consts, tensors) for e in v]}
    if isinstance(v, dict) and all(isinstance(k, str) for k in v):
        return {"dict": {k: _bake(e, consts, tensors) for k, e in v.items()}}
    raise DecompError(f"cannot bake a {type(v).__name__} into an AOT "
                      "artifact (configuration is numbers, strings, "
                      "dtypes, devices, tensors, arrays, SplitComplex, a "
                      "DeviceMesh and tuples, lists and dicts of them)")


def _unbake(node, consts, mesh):
    """The value of a baked node: tensors and arrays from ``consts`` (name
    -> tensor on the call's device or numpy array), a mesh from
    ``mesh(spec)``."""
    if not isinstance(node, (dict, list)):
        return node
    if not isinstance(node, dict) or len(node) != 1:
        raise DecompError(f"corrupt AOT artifact configuration {node!r}")
    (kind, val), = node.items()
    if kind in ("tensor", "ndarray"):
        return consts[val]
    if kind == "dtype":
        return _dtype(val)
    if kind == "device":
        return torch.device(val)
    if kind == "split":
        return _result.SplitComplex(_unbake(val[0], consts, mesh),
                                    _unbake(val[1], consts, mesh))
    if kind == "mesh":
        return mesh(val)
    if kind in ("tuple", "list"):
        out = [_unbake(e, consts, mesh) for e in val]
        return tuple(out) if kind == "tuple" else out
    if kind == "dict":
        return {k: _unbake(e, consts, mesh) for k, e in val.items()}
    raise DecompError(f"corrupt AOT artifact configuration {node!r}")


# --- the artifact -------------------------------------------------------------

class AotSolver:
    """A solve with its inputs pinned, its configuration baked and, for
    'cuda', its built libraries carried. Call it with the pinned
    positional inputs; it returns the family's Result NamedTuple."""

    def __init__(self, header, constants: bytes, libraries):
        """``header``: the artifact's JSON header; ``constants``: the
        baked arrays as ``np.savez`` bytes; ``libraries``: the carried
        libraries' bytes, in the header's order."""
        cls_name = header["result_cls"]
        if cls_name not in _RESULT_CLASSES:
            raise DecompError(
                f"unknown result class {cls_name!r} in AOT artifact "
                f"(supported: {sorted(_RESULT_CLASSES)})")
        self._fn = _resolve(header["module"], header["qualname"])
        if self._fn is None:
            raise DecompError(
                f"AOT artifact names {header['module']}."
                f"{header['qualname']}, which is no solve of {_PACKAGE}")
        self._header = header
        self._constants = constants
        self._libraries = list(libraries)
        try:
            with np.load(io.BytesIO(constants), allow_pickle=False) as z:
                self._arrays = {k: z[k] for k in z.files}
        except (ValueError, OSError) as e:
            raise DecompError(f"corrupt AOT artifact constants: {e}") from e
        self._on_device = {}   # str(device) -> baked values for a call there
        self._meshes = {}      # device type -> the rebuilt DeviceMesh

    @property
    def in_avals(self):
        """The pinned inputs (the call contract): ``device='meta'``
        tensors, SplitComplex pairs of them, ``numbers.Real`` for a real
        number, None for None."""
        return tuple(_spec(p) for p in self._header["pins"])

    @property
    def platforms(self):
        """The platforms the call's tensors may lie on."""
        return tuple(self._header["platforms"])

    @property
    def libraries(self):
        """The carried libraries' file names."""
        return tuple(lib["file"] for lib in self._header["libraries"])

    def _consts(self, device):
        """The baked arrays, their tensors moved to ``device`` once."""
        key = str(device)
        if key not in self._on_device:
            out = dict(self._arrays)
            for name, dtype in self._header["tensors"].items():
                t = torch.from_numpy(self._arrays[name])
                if dtype == "bfloat16":
                    t = t.view(torch.bfloat16)
                out[name] = t.to(device, copy=True)
            self._on_device[key] = out
        return self._on_device[key]

    def _mesh(self, spec, device_type):
        """The baked mesh rebuilt in the caller's world (once)."""
        if device_type not in self._meshes:
            layout = torch.tensor(spec["layout"], dtype=torch.int)
            n = layout.numel()
            world = (dist.get_world_size() if dist.is_available()
                     and dist.is_initialized() else None)
            if world != n:
                raise DecompError(
                    f"AOT artifact exported for {n} ranks (mesh "
                    f"{tuple(layout.shape)} {tuple(spec['names'])}), "
                    "called " + ("outside a process group" if world is None
                                 else f"in a world of {world}"))
            self._meshes[device_type] = DeviceMesh(
                device_type, layout, mesh_dim_names=tuple(spec["names"]))
        return self._meshes[device_type]

    def __call__(self, *inputs):
        pins, platforms = self._header["pins"], self.platforms
        if len(inputs) != len(pins):
            raise DecompError(f"AOT artifact takes {len(pins)} positional "
                              f"inputs, got {len(inputs)}")
        for i, (pin, a) in enumerate(zip(pins, inputs)):
            _check(i, pin, a, platforms)
        devices = {t.device for a in inputs for t in _tensors(a)}
        if len(devices) > 1:
            raise DecompError(f"AOT inputs on several devices: "
                              f"{sorted(map(str, devices))}")
        device = devices.pop() if devices else torch.device(platforms[0])
        consts = self._consts(device)

        def value(node):
            return _unbake(node, consts,
                           lambda spec: self._mesh(spec, device.type))

        args = [value(a) for a in self._header["args"]]
        kwargs = {k: value(v) for k, v in self._header["kwargs"].items()}
        return self._fn(*args, *inputs, **kwargs)

    def serialize(self) -> bytes:
        header = json.dumps(self._header).encode()
        return (_MAGIC + header + b"\n" + self._constants
                + b"".join(self._libraries))

    def save(self, path) -> None:
        with open(path, "wb") as f:
            f.write(self.serialize())


def export_solver(solve_fn, *example_args, platforms=None,
                  **solve_kwargs) -> AotSolver:
    """Pin ``solve_fn(*example_args, **solve_kwargs)`` into a serializable
    artifact.

    ``solve_fn``: a public solve of ``decomp_tpu_torch`` (``nmf.solve``,
    ``nmf.masked_completion``, ``lasso.solve``, ``lasso.solve_split``,
    ``dictionary_learning.solve``, ``parallel.*``, ...) or a
    ``functools.partial`` of one, whose arguments are baked in.

    ``example_args``: the request-time positional inputs: tensors or
    ``device='meta'`` specs (pinned by shape and dtype), SplitComplex
    pairs of them, real numbers, None. Where every tensor has values, the
    export runs the solve once on them, which checks its Result class and
    records the libraries that it launches; with a spec it runs nothing
    and the result class comes from the solve's return annotation.

    ``platforms``: the device types ('cpu', 'cuda') that a call's tensors
    may lie on. None: the example tensors' device type, or 'cuda' (where
    the port's entry points run by default) for specs alone.

    ``solve_kwargs``: the configuration, baked in (see the module
    docstring for what it may hold).
    """
    fn, module, qualname, args, kwargs = _solve_name(solve_fn)
    kwargs.update(solve_kwargs)
    consts, baked = {}, {}
    config = {"args": [_bake(a, consts, baked) for a in args],
              "kwargs": {k: _bake(v, consts, baked)
                         for k, v in kwargs.items()}}
    pins = [_pin(a) for a in example_args]
    tensors = [t for a in example_args for t in _tensors(a)]
    if platforms is None:
        kinds = {t.device.type for t in tensors if not t.is_meta}
        if len(kinds) > 1:
            raise DecompError(f"example tensors on several device types "
                              f"{sorted(kinds)}: pass platforms=")
        platforms = tuple(kinds) or ("cuda",)
    platforms = tuple(platforms)
    if (not platforms or len(set(platforms)) != len(platforms)
            or any(p not in _PLATFORMS for p in platforms)):
        raise DecompError(f"platforms must be distinct names among "
                          f"{_PLATFORMS}, got {platforms!r}")
    for t in tensors:
        if not t.is_meta and t.device.type not in platforms:
            raise DecompError(f"an example tensor lies on {t.device.type}, "
                              f"outside platforms {platforms}")

    reached = set()
    if any(t.is_meta for t in tensors):
        cls_name = _annotated_result(fn)
        got = f"is annotated {cls_name}"
    else:
        with _build.recording() as reached:
            res = fn(*args, *example_args, **kwargs)
        cls_name = type(res).__name__
        got = f"returned {cls_name}"
        if _RESULT_CLASSES.get(cls_name) is not type(res):
            cls_name = None
    if cls_name not in _RESULT_CLASSES:
        raise DecompError(
            f"{qualname!r} {got}, not a decomp_tpu_torch Result pytree; "
            "export_solver wraps the public solve() entries")

    header = {
        "format": 1,
        "result_cls": cls_name,
        "module": module,
        "qualname": qualname,
        "platforms": list(platforms),
        "pins": pins,
        **config,
        "tensors": baked,
    }
    buf = io.BytesIO()
    np.savez(buf, **consts)
    constants = buf.getvalue()
    blobs = [_build.library_path(s).read_bytes() for s in sorted(reached)]
    header["constants_bytes"] = len(constants)
    header["capability"] = list(_build.CAPABILITY) if blobs else None
    header["libraries"] = [
        {"file": _build.library_path(s).name,
         "sha256": hashlib.sha256(b).hexdigest(), "bytes": len(b)}
        for s, b in zip(sorted(reached), blobs)]
    return AotSolver(header, constants, blobs)


def load_solver(src) -> AotSolver:
    """Reload an artifact from ``save()``/``serialize()`` output, and
    install the libraries that it carries (``ops._build.install``) before
    any call: each must match its digest and be this package's build of
    its source (the same sources, headers and flags), and, where a card is
    visible, the card must have the capability they were built for.

    ``src``: a path, a file-like object, or bytes.
    """
    if isinstance(src, (bytes, bytearray)):
        data = bytes(src)
    elif hasattr(src, "read"):
        data = src.read()
    else:
        with open(src, "rb") as f:
            data = f.read()
    if not data.startswith(_MAGIC):
        raise DecompError("not a decomp_tpu_torch AOT artifact (bad magic)")
    header_line, _, body = data[len(_MAGIC):].partition(b"\n")
    try:
        header = json.loads(header_line.decode())
        cls_name = header["result_cls"]
    except (ValueError, KeyError, TypeError) as e:
        raise DecompError(f"corrupt AOT artifact header: {e!r}") from e
    if cls_name not in _RESULT_CLASSES:
        raise DecompError(
            f"unknown result class {cls_name!r} in AOT artifact "
            f"(supported: {sorted(_RESULT_CLASSES)})")
    try:
        if header["format"] != 1:
            raise ValueError(f"format {header['format']!r}")
        for key in ("module", "qualname", "platforms", "pins", "args",
                    "kwargs", "tensors", "capability"):
            header[key]
        sizes = [int(header["constants_bytes"])] + [
            int(lib["bytes"]) for lib in header["libraries"]]
        files = [(lib["file"], lib["sha256"])
                 for lib in header["libraries"]]
    except (KeyError, TypeError, ValueError) as e:
        raise DecompError(f"corrupt AOT artifact header: {e!r}") from e
    if sum(sizes) != len(body):
        raise DecompError(f"corrupt AOT artifact payload: {len(body)} "
                          f"bytes where the header names {sum(sizes)}")
    parts, at = [], 0
    for n in sizes:
        parts.append(body[at:at + n])
        at += n
    if files:
        cap = tuple(header["capability"] or ())
        if cap != _build.CAPABILITY:
            raise DecompError(f"AOT artifact libraries built for capability "
                              f"{cap}; this package builds for "
                              f"{_build.CAPABILITY}")
        if torch.cuda.is_available():
            card = torch.cuda.get_device_capability()
            if card != cap:
                raise DecompError(f"AOT artifact libraries run on "
                                  f"capability {cap}; this card has {card}")
        for (name, digest), blob in zip(files, parts[1:]):
            _build.install(name, blob, digest)
    return AotSolver(header, parts[0], parts[1:])
