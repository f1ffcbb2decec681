"""Runtime controls and the configuration dump — counterpart of
``tpukk/common/controls.py`` (sparse/src/KokkosKernels_Controls.hpp:46-70, a
string key→value map read by algorithm selection, and
common/src/KokkosKernels_PrintConfiguration.hpp /
KokkosKernels_EagerInitialize.hpp:17-40).

``print_configuration`` names torch, CUDA and the card (``nvidia-smi``'s name
and power limit, or ``torch.cuda.get_device_name`` where ``nvidia-smi`` does
not answer).  ``eager_initialize`` builds up front what ``_kernels.py`` would
build at first use: every CUDA kernel and the host planners on a CUDA device,
the host planners (``csrc/host.cpp``) alone on the CPU.
"""
from __future__ import annotations

import dataclasses
import subprocess
import time
from typing import Dict

import torch

__all__ = ["Controls", "print_configuration", "eager_initialize", "device_description"]


@dataclasses.dataclass
class Controls:
    """String key→value tuning map (cf. KokkosKernels_Controls.hpp).

    Recognized keys mirror the reference's: "algorithm" ("native"/"merge"/
    "dia"/"ell"/...) read by ``spmv_algorithm``."""

    params: Dict[str, str] = dataclasses.field(default_factory=dict)

    def set(self, key: str, value: str):
        self.params[key] = str(value)
        return self

    def get(self, key: str, default: str = "") -> str:
        return self.params.get(key, default)

    def spmv_algorithm(self):
        """Translate the "algorithm" control into SpmvAlgorithm (the role of
        sparse/src/KokkosSparse_spmv_deprecated.hpp:151-156)."""
        from ..sparse.spmv import SpmvAlgorithm

        name = self.get("algorithm", "auto").lower()
        mapping = {
            "default": SpmvAlgorithm.AUTO,
            "auto": SpmvAlgorithm.AUTO,
            "native": SpmvAlgorithm.ELL,
            "merge": SpmvAlgorithm.ELL,   # static bucketing replaces merge-path
            "dia": SpmvAlgorithm.DIA,
            "ell": SpmvAlgorithm.ELL,
            "segsum": SpmvAlgorithm.SEGSUM,
            "dense": SpmvAlgorithm.DENSE,
        }
        return mapping.get(name, SpmvAlgorithm.AUTO)


def device_description() -> str:
    """The CUDA card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them (its
    name alone from torch where nvidia-smi does not answer), or "cpu" where
    there is no CUDA device."""
    if not torch.cuda.is_available():
        return "cpu"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", f"--id={torch.cuda.current_device()}"],
                             capture_output=True, text=True, timeout=60)
        line = out.stdout.strip().splitlines()[0] if out.returncode == 0 else ""
    except (OSError, subprocess.TimeoutExpired, IndexError):
        line = ""
    return line or torch.cuda.get_device_name()


def print_configuration(out=None) -> str:
    """Configuration dump (cf. KokkosKernels_PrintConfiguration.hpp)."""
    from .. import __version__, _kernels
    from .types import supported_scalars

    cuda = torch.cuda.is_available()
    lines = [
        f"tpukk_torch version: {__version__}",
        f"torch version: {torch.__version__}",
        f"CUDA version: {torch.version.cuda}",
        f"device: {device_description() if cuda else 'cpu (no CUDA device)'}",
        "f64 enabled: always (native on the GPU and the CPU)",
        f"scalar dtypes: {[str(s).replace('torch.', '') for s in supported_scalars()]}",
        f"kernels built: {sorted(n for n in _kernels._libs if n in _kernels.SOURCES) or 'none yet'}",
        f"host planners (csrc/host.cpp): {'built' if 'host' in _kernels._libs else 'not built yet'}",
    ]
    text = "\n".join(lines)
    if out is not None:
        out.write(text + "\n")
    return text


def eager_initialize(device=None) -> float:
    """Build up front what would be built at first use (cf.
    KokkosKernels::eager_initialize, KokkosKernels_EagerInitialize.hpp:17-40):
    on a CUDA device every kernel and the host planners, and the device's
    context; on the CPU the host planners alone.  ``device`` None means the
    CUDA device.  Returns the seconds spent."""
    from .. import _kernels
    from .types import default_device

    dev = default_device(device)
    t0 = time.perf_counter()
    if dev.type == "cuda":
        _kernels.build_all()
        torch.zeros(1, device=dev).add_(1.0)
        torch.cuda.synchronize(dev)
    else:
        _kernels.library("host")
    return time.perf_counter() - t0
