"""Build and load the port's CUDA kernels.

Each ``mxnet_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` into its
own shared library with a plain C interface,
``mxnet_tpu_torch/_build/<name>-<hash>.so``, and loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds, not minutes).  The hash
covers the sources, the headers and the flags, so an edited kernel is
rebuilt and an unchanged one is reused.  Builds run at first use;
:func:`build` starts one ``nvcc`` per source, all at once.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` turns a non-zero code into a ``RuntimeError`` naming the
CUDA error.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["build", "load", "check", "SOURCES", "BUILD_DIR"]

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
#: one shared library per kernel source
SOURCES = ("paged_attention", "fused_decode", "decode_phase", "quant_matmul",
           "epilogue", "flash_attention", "lstm")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs = {}


def _nvcc():
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (looked on PATH and in %s/bin)"
                           % home)
    return path


def _target(name):
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / (name + ".cu")]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / ("%s-%s.so" % (name, h.hexdigest()[:16]))


def build(names=SOURCES):
    """Compile the named sources that have no up-to-date library yet, one
    ``nvcc`` process per source, started together.  Returns
    ``{name: path}``; raises ``RuntimeError`` with the compiler's output
    when any build fails.  Each build's ``-Xptxas -v`` report (registers,
    shared memory, spills) is kept beside its library as ``.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, procs = {}, {}
    for name in names:
        so = _target(name)
        out[name] = so
        if so.exists():
            continue
        tmp = so.with_suffix(".so.tmp%d" % os.getpid())
        cmd = [_nvcc(), *FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / (name + ".cu"))]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT),
                       tmp, so)
    failed = []
    for name, (proc, tmp, so) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        so.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append("%s (nvcc exit %d):\n%s"
                          % (name, proc.returncode, log))
            continue
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return out


def load(name):
    """The loaded ``ctypes.CDLL`` of kernel source ``name`` (built on
    first use)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            lib.mxt_error_string.argtypes = [ctypes.c_int]
            lib.mxt_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib, rc, what):
    """Raise when a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError("%s: CUDA error %d (%s)" % (
            what, rc, lib.mxt_error_string(rc).decode()))
