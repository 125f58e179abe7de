"""Build the port's C API library and its two C clients (`native/`).

`build()` compiles `native/yafaray_tpu_c_api.cc` with g++ into
`libyafaray_tpu_c_api.so`, which embeds CPython and drives this package,
and links `native/tests/test00_client.c` and `test05_client.c` against it
with gcc. The three land in one directory under `_build/capi/`, named by a
hash of the sources, the flags and the Python they embed; a build is made
in a temporary directory and then renamed into place, so a build that
fails or is cut leaves nothing behind. The embedding flags come from
`sysconfig` (the include directory, LIBDIR, LDVERSION), not from
`python3-config`. A failed build raises with the compiler's stderr.

`start_client(name, device, outdir)` starts a built client as its own
process with this checkout on PYTHONPATH: `device` is its first argument
(None: none staged, so the card), `outdir` the directory of its PNG.
`run_client` runs one to its end.
`client_numbers(img)` computes the numbers test00_client prints for an
image, as it computes them.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sysconfig
import tempfile

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
NATIVE_DIR = os.path.join(_PKG, "native")
BUILD_DIR = os.path.join(_PKG, "_build", "capi")
LIBRARY = "libyafaray_tpu_c_api.so"
CLIENTS = ("test00_client", "test05_client")
CXXFLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall")
CFLAGS = ("-O2",)
CLIENT_TIMEOUT = 600   # seconds a client may take, its first render included
_SOURCES = ("yafaray_tpu_c_api.cc", "include/yafaray_tpu_c_api.h",
            "tests/test00_client.c", "tests/test05_client.c")


def embed_flags():
    """(compile flags, link flags) that embed this interpreter's Python."""
    libdir = sysconfig.get_config_var("LIBDIR")
    cflags = [f"-I{sysconfig.get_paths()['include']}"]
    ldflags = [f"-L{libdir}",
               f"-lpython{sysconfig.get_config_var('LDVERSION')}",
               f"-Wl,-rpath,{libdir}"]
    for var in ("LIBS", "SYSLIBS"):
        ldflags += (sysconfig.get_config_var(var) or "").split()
    return cflags, ldflags


def _run(cmd):
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"C API build failed: {' '.join(cmd)}\n"
                           f"{proc.stderr}")


def build() -> str:
    """Build the library and both clients unless this exact build exists;
    returns the directory that holds them."""
    cflags, ldflags = embed_flags()
    h = hashlib.sha256()
    for rel in _SOURCES:
        with open(os.path.join(NATIVE_DIR, rel), "rb") as fh:
            h.update(fh.read())
    h.update(" ".join((*CXXFLAGS, *CFLAGS, *cflags, *ldflags)).encode())
    out = os.path.join(BUILD_DIR, h.hexdigest()[:16])
    if all(os.path.exists(os.path.join(out, f)) for f in (LIBRARY, *CLIENTS)):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=".tmp-", dir=BUILD_DIR)
    try:
        _run(["g++", *CXXFLAGS, *cflags, "-shared",
              f"-Wl,-soname,{LIBRARY}", "-o", os.path.join(tmp, LIBRARY),
              os.path.join(NATIVE_DIR, "yafaray_tpu_c_api.cc"), *ldflags])
        for client in CLIENTS:
            _run(["gcc", *CFLAGS,
                  f"-I{os.path.join(NATIVE_DIR, 'include')}", "-o",
                  os.path.join(tmp, client),
                  os.path.join(NATIVE_DIR, "tests", f"{client}.c"),
                  f"-L{tmp}", "-lyafaray_tpu_c_api", "-Wl,-rpath,$ORIGIN"])
        try:
            os.rename(tmp, out)
        except OSError:
            if not os.path.isdir(out):     # not a build that won the race
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def start_client(name: str, device, outdir: str) -> subprocess.Popen:
    """Start the built client `name` (test00_client or test05_client) with
    `device` staged (None: none) and its PNG written under `outdir`; its
    output is piped as text."""
    env = dict(os.environ)
    repo = os.path.dirname(_PKG)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen([os.path.join(build(), name), device or "",
                             outdir], env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def run_client(name: str, device, outdir: str):
    """start_client run to its end (at most CLIENT_TIMEOUT s); returns
    the CompletedProcess."""
    proc = start_client(name, device, outdir)
    try:
        out, err = proc.communicate(timeout=CLIENT_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    return subprocess.CompletedProcess(proc.args, proc.returncode, out, err)


def client_numbers(img) -> dict:
    """mean, left_r and left_g of a float32 [H, W, 4] image as test00_client
    computes and prints them: the mean of (r + g + b) / 3 (the sum in
    float, the division and the accumulation in double), and the sums of r
    and of g over the six leftmost columns."""
    img = np.asarray(img, np.float32)
    rgb = ((img[..., 0] + img[..., 1]) + img[..., 2]).astype(np.float64)
    mean = 0.0
    for v in (rgb / 3.0).reshape(-1):
        mean += v
    left_r = left_g = 0.0
    for y in range(img.shape[0]):
        for x in range(min(6, img.shape[1])):
            left_r += float(img[y, x, 0])
            left_g += float(img[y, x, 1])
    return {"mean": float(mean) / (img.shape[0] * img.shape[1]),
            "left_r": left_r, "left_g": left_g}


def parse_numbers(stdout: str) -> dict:
    """The "mean=... left_r=... left_g=..." line a test00_client printed."""
    line = next(l for l in stdout.splitlines() if l.startswith("mean="))
    return {k: float(v) for k, v in (kv.split("=") for kv in line.split())}
