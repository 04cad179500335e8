"""Accelerator plumbing shared by ``chip_smoke.py`` and ``bench.py``: the
GPU guard, the persistent compile cache, and the card's name and power
limit."""

import ctypes
import os
from pathlib import Path
from typing import List

CHECKOUT = Path(__file__).resolve().parents[2]


def require_gpu(devices) -> None:
    """Exit non-zero unless JAX's default devices are GPUs.  A
    measurement never falls back to the CPU."""
    if not devices or devices[0].platform != "gpu":
        platform = devices[0].platform if devices else "none"
        raise SystemExit(f"no GPU found: JAX's default devices are {platform!r}")


def configure_compile_cache(root: Path = CHECKOUT) -> str:
    """Use ``<root>/.jax_cache`` as JAX's persistent compile cache unless
    ``JAX_COMPILATION_CACHE_DIR`` is set (JAX then reads it itself and
    nothing is set here).  Returns the directory in use."""
    import jax

    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return os.environ["JAX_COMPILATION_CACHE_DIR"]
    path = str(Path(root) / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def card_lines() -> List[str]:
    """One ``"<name>, <limit> W"`` line per card, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them, read from NVML in this process."""
    nvml = ctypes.CDLL("libnvidia-ml.so.1")
    uint_p, handle_p = ctypes.POINTER(ctypes.c_uint), ctypes.POINTER(ctypes.c_void_p)
    for fn, args in (("nvmlInit_v2", []), ("nvmlShutdown", []),
                     ("nvmlDeviceGetCount_v2", [uint_p]),
                     ("nvmlDeviceGetHandleByIndex_v2", [ctypes.c_uint, handle_p]),
                     ("nvmlDeviceGetName", [ctypes.c_void_p, ctypes.c_char_p,
                                            ctypes.c_uint]),
                     ("nvmlDeviceGetPowerManagementLimit", [ctypes.c_void_p, uint_p])):
        getattr(nvml, fn).argtypes = args
        getattr(nvml, fn).restype = ctypes.c_int

    def check(rc, what):
        if rc != 0:
            raise RuntimeError(f"NVML {what} failed with code {rc}")

    check(nvml.nvmlInit_v2(), "init")
    try:
        n = ctypes.c_uint()
        check(nvml.nvmlDeviceGetCount_v2(ctypes.byref(n)), "device count")
        lines = []
        for i in range(n.value):
            handle = ctypes.c_void_p()
            check(nvml.nvmlDeviceGetHandleByIndex_v2(i, ctypes.byref(handle)),
                  "device handle")
            name = ctypes.create_string_buffer(96)
            check(nvml.nvmlDeviceGetName(handle, name, 96), "device name")
            milliwatts = ctypes.c_uint()
            check(nvml.nvmlDeviceGetPowerManagementLimit(
                handle, ctypes.byref(milliwatts)), "power limit")
            lines.append(f"{name.value.decode()}, {milliwatts.value / 1000:.2f} W")
        return lines
    finally:
        nvml.nvmlShutdown()
