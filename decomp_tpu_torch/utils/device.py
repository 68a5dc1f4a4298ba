"""Where an entry point runs: the card unless the caller asks for the CPU.

A ``torch.Tensor`` stays on its device: that is the caller's choice. A host
array (numpy, a list, a scalar) goes to ``device=`` if given, else to
``torch.device('cuda')``; with no CUDA device and no ``device`` the entry
point raises instead of carrying on quietly on the CPU. The companion
arguments follow the data's device when they are host arrays; a tensor on
another device is refused, never moved.
"""

import torch

from decomp_tpu_torch.utils.exceptions import DecompError


def resolve(y, device=None) -> torch.device:
    """The device an entry point runs on for data ``y`` (see the module
    docstring)."""
    if isinstance(y, torch.Tensor):
        if device is not None and not _same(torch.device(device), y.device):
            raise DecompError(f"y is on {y.device} but device={device!r}; "
                              "move it explicitly")
        return y.device
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DecompError("no CUDA device: pass device='cpu' (or a CPU "
                          "tensor) to run on the CPU")
    return dev


def on_device(name, t, device, dtype=None):
    """``t`` as a tensor on ``device`` (a host array is copied there), cast
    to ``dtype`` if given; a tensor on another device is refused."""
    if isinstance(t, torch.Tensor):
        if not _same(t.device, torch.device(device)):
            raise DecompError(f"{name} is on {t.device} but y is on {device}; "
                              "move it explicitly")
        return t if dtype is None else t.to(dtype)
    # Straight to ``dtype``: a Python float made f32 first would lose bits.
    return torch.as_tensor(t, dtype=dtype, device=device)


def _same(a, b):
    """Whether two devices are one; a device without an index (``cuda``)
    names the current one of its type."""
    if a.type != b.type:
        return False
    if a.type != "cuda" or a.index == b.index:
        return True
    cur = torch.cuda.current_device()
    return (cur if a.index is None else a.index) == (
        cur if b.index is None else b.index)
