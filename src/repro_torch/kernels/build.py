"""Build and load the Hopper kernels of ``repro_torch/csrc``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface (no PyTorch headers, so a build takes seconds) and
loaded with ``ctypes``::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o <build>/<name>-<hash>.so csrc/<name>.cu

No ``--use_fast_math``: it would make the IEEE divisions of Algorithm 1
approximate and flush subnormals, and the kernels are bitwise to the format.
The build happens on first use (or through :func:`build_all`), all sources in
parallel, into ``src/repro_torch/_build/`` (git-ignored; override with
``REPRO_TORCH_BUILD_DIR``). A library's file name carries a hash of its
sources and flags, so an edited source is rebuilt and a stale one never
loaded. Nothing here runs at import time.

Every wrapper counts its launches in :data:`LAUNCHES` (one per kernel launch
and nowhere else), so a run can show that its main path went through the
kernels; the matmul wrappers also count them per (M, K, N) in
:data:`SHAPE_LAUNCHES`, the quantizer per (M, K) and the KV append per
(B, Hkv, Dh, tensors, paged), so a run can show which shapes its main path
gave them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("hif4_quant", "fused_matmul", "fused_decode_matmul",
           "fused_attention", "bfp_matmul", "bfp_decode_matmul", "kv_append")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# "fused_packed_matmul" counts kernel 2 in either form; its decode form
# (kernel 1 on the activations folded in) also counts under
# "fused_decode_matmul". Likewise "bfp_matmul_quantized" counts kernel 5 in
# either form, and its decode form (kernel 1 on the weight folded in) also
# under "bfp_decode_matmul".
LAUNCHES: dict = {"hif4_quantize": 0, "fused_packed_matmul": 0,
                  "fused_decode_matmul": 0, "fused_decode_attention": 0,
                  "fused_paged_decode_attention": 0, "bfp_matmul_quantized": 0,
                  "bfp_decode_matmul": 0, "kv_append": 0}

# (kernel, (M, K, N)) -> launches, where the wrapper names its shape
SHAPE_LAUNCHES: dict = {}

_LIBS: dict = {}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0
    SHAPE_LAUNCHES.clear()


def count_launch(kernel: str, shape: tuple | None = None) -> None:
    LAUNCHES[kernel] += 1
    if shape is not None:
        key = (kernel, tuple(shape))
        SHAPE_LAUNCHES[key] = SHAPE_LAUNCHES.get(key, 0) + 1


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    return Path(env) if env else CSRC.parent / "_build"


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            "/usr/local/cuda/bin/nvcc"]:
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> dict:
    """Compile every missing library, one ``nvcc`` per source, all started
    together. Returns {name: seconds} (0.0 for a library already built)."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), tmp, target)
    seconds = {name: 0.0 for name in names}
    errors = []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n"
                          + log.decode(errors="replace"))
            continue
        os.replace(tmp, target)
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def library(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        target = _target(name)
        if not target.exists():
            build_all()
        lib = ctypes.CDLL(str(target))
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def function(lib_name: str, fn_name: str, argtypes: list,
             restype=ctypes.c_int):
    """The C function ``fn_name`` of a library, with its signature declared
    (ctypes would otherwise pass pointers as 32-bit ints)."""
    fn = getattr(library(lib_name), fn_name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = restype
    return fn


def check(lib_name: str, kernel: str, rc: int, shape: tuple | None = None
          ) -> None:
    """Raise if a launch returned a CUDA error; count it otherwise (per
    ``shape`` too, where the wrapper gives one)."""
    if rc != 0:
        msg = library(lib_name).repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{kernel}: CUDA error {rc} ({msg})")
    count_launch(kernel, shape)


def stream_ptr(device) -> int:
    """The current CUDA stream of ``device``, as the kernels' last argument."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
