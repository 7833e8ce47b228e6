"""The port's native layer on the CPU: ``utils/native.py`` (ctypes bindings
of ``native/matinv_host.cpp``) against the port's own generator and
residuals, and the port's C ABI (``native/mat_inv_c_torch.cpp``, built by
``native/Makefile.torch`` into ``native/build/torch/``) driven end to end
by the native benchmark driver and by a C consumer of ``native/matinv.h``,
as ``tests/test_native.py`` drives the JAX package's. ``MATINV_DEVICE=cpu``
is the explicit ask for the CPU: the library's default is the card.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gpu_matrix_inversion_tpu.utils import native as jnative  # noqa: E402
from gpu_matrix_inversion_tpu_torch.utils import native  # noqa: E402
from gpu_matrix_inversion_tpu_torch.utils.generators import (  # noqa: E402
    hollow_random_matrix)
from gpu_matrix_inversion_tpu_torch.utils.residual import (  # noqa: E402
    reference_error_metric, relative_residual)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(REPO, "native")
BUILD = os.path.join(NATIVE, "build", "torch")


@pytest.fixture(scope="module")
def built():
    if shutil.which("g++") is None or shutil.which("make") is None:
        pytest.skip("no native toolchain")
    r = subprocess.run(["make", "-C", NATIVE, "-f", "Makefile.torch"],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-400:]
    return BUILD


@pytest.fixture
def host_lib(built, monkeypatch):
    """``utils/native`` bound to the host library of this build."""
    monkeypatch.setattr(native, "_LIB_PATH",
                        os.path.join(built, "libmatinv_host.so"))
    monkeypatch.setattr(native, "_lib", None)
    assert native.available()
    return native


def _env() -> dict:
    env = dict(os.environ)
    env["MATINV_DEVICE"] = "cpu"
    site = [p for p in sys.path if p.endswith("site-packages")]
    env["PYTHONPATH"] = ":".join(site + [REPO])
    return env


def test_host_lib_residuals(host_lib):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((64, 64))
    inv = np.linalg.inv(a)
    assert abs(host_lib.reference_error(inv, a)
               - reference_error_metric(a, inv)) < 1e-9
    assert abs(host_lib.relative_residual(inv, a)
               - relative_residual(a, inv)) < 1e-12


def test_host_lib_generator(host_lib):
    a = host_lib.hollow_random(32, seed=7)
    assert a.shape == (32, 32) and a.dtype == np.float32
    assert np.all(np.diag(a) == 0)
    off = a[~np.eye(32, dtype=bool)]
    assert off.min() >= 0.0 and off.max() < 100.0 and np.std(off) > 10
    np.testing.assert_array_equal(a, host_lib.hollow_random(32, seed=7))
    assert not np.array_equal(a, host_lib.hollow_random(32, seed=8))


def test_numpy_fallback_is_the_ports_own(monkeypatch):
    """Without the library the bindings fall back to the port's generator
    and residuals, which equal the JAX package's fallback."""
    for mod in (native, jnative):
        monkeypatch.setattr(mod, "_LIB_PATH", os.path.join(REPO, "missing"))
        monkeypatch.setattr(mod, "_lib", None)
    assert not native.available()
    a = native.hollow_random(48, seed=3)
    np.testing.assert_array_equal(a, hollow_random_matrix(48, seed=3))
    np.testing.assert_array_equal(a, jnative.hollow_random(48, seed=3))
    inv = np.linalg.inv(a.astype(np.float64))
    assert native.relative_residual(inv, a) == relative_residual(a, inv)
    assert native.reference_error(inv, a) == jnative.reference_error(inv, a)


def test_c_abi_library_end_to_end(built):
    """The native driver on the port's C ABI: a C++ consumer inverts a
    48^2 hollow matrix through the embedded interpreter and the port's
    ``matrix_inv_32`` (on the CPU, asked for), then solves with it."""
    exe = os.path.join(built, "matinv_bench")
    r = subprocess.run([exe, "48"], capture_output=True, text=True,
                       env=_env(), timeout=300)
    assert r.returncode == 0, r.stderr[-400:]
    row = r.stdout.strip().splitlines()[-1].split()
    assert row[0] == "48" and float(row[3]) < 1e-5
    r = subprocess.run([exe, "--fp64", "48"], capture_output=True, text=True,
                       env=_env(), timeout=300)
    assert r.returncode == 0, r.stderr[-400:]
    assert float(r.stdout.strip().splitlines()[-1].split()[3]) < 1e-12
    r = subprocess.run([exe, "--solve", "48"], capture_output=True,
                       text=True, env=_env(), timeout=300)
    assert r.returncode == 0, r.stderr[-400:]


def test_c_consumer_against_header(built, tmp_path):
    """A C consumer compiled against ``native/matinv.h`` and linked to the
    port's library: an inverse, status 1 on a singular matrix with ``out``
    untouched, and a solve."""
    src = tmp_path / "consumer.c"
    src.write_text(r'''
#include "matinv.h"
#include <stdio.h>

int main(void) {
  enum { n = 32 };
  static float a[n * n], inv[n * n], b[n], x[n];
  unsigned s = 12345;
  int i, j, k;
  for (i = 0; i < n * n; i++) {  /* hollow random, reference protocol */
    s = s * 1664525u + 1013904223u;
    a[i] = (float)(s >> 8) / 16777216.0f * 100.0f;
  }
  for (i = 0; i < n; i++) a[i * n + i] = 0.0f;
  if (matinv_tpu_init() != 0) return 2;
  if (matrix_inv_32(a, n, inv) != 0) return 3;
  double worst = 0.0;
  for (i = 0; i < n; i++)
    for (j = 0; j < n; j++) {
      double acc = 0.0, d;
      for (k = 0; k < n; k++) acc += (double)a[i * n + k] * inv[k * n + j];
      d = acc - (i == j ? 1.0 : 0.0);
      if (d < 0) d = -d;
      if (d > worst) worst = d;
    }
  if (worst > 1e-3) { fprintf(stderr, "resid %g\n", worst); return 4; }
  for (i = 0; i < n; i++) b[i] = (float)(i % 5) - 2.0f;
  if (matrix_solve_32(a, b, n, 1, x) != 0) return 5;
  for (i = 0; i < n; i++) {
    double acc = 0.0, d;
    for (k = 0; k < n; k++) acc += (double)a[i * n + k] * x[k];
    d = acc - b[i];
    if (d > 1e-3 || d < -1e-3) { fprintf(stderr, "solve %g\n", d); return 6; }
  }
  for (i = 0; i < n * n; i++) a[i] = 1.0f;
  inv[0] = 42.0f;
  if (matrix_inv_32(a, n, inv) != 1 || inv[0] != 42.0f) return 7;
  printf("c consumer ok (worst abs err %g)\n", worst);
  return 0;
}
''')
    exe = tmp_path / "consumer"
    r = subprocess.run(
        ["gcc", str(src), "-I", NATIVE, "-L", built,
         f"-Wl,-rpath,{built}", "-lmatinv_torch", "-o", str(exe)],
        capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-400:]
    r = subprocess.run([str(exe)], capture_output=True, text=True,
                       env=_env(), timeout=300)
    assert r.returncode == 0, (r.returncode, r.stderr[-400:])
    assert "c consumer ok" in r.stdout
