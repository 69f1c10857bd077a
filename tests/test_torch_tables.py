"""The PyTorch port's encoder parameters against the JAX reference: the
quantizer, lambda and rate tables, the SNS quant curve, the segment plan
arithmetic, and the package's isolation from JAX, Pillow, the reference
package, its environment switches and its build products."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from webp_tpu.lossy import tables as T_ref
from webp_tpu.ops import fastpath as FP_ref
from webp_tpu_torch.lossy import tables as T
from webp_tpu_torch.ops import fastpath as FP

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "webp_tpu_torch")


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_all_q_tables_equal_reference():
    got, ref = FP.all_q_tables(), FP_ref.all_q_tables()
    for k in ("y1", "y2", "uv"):
        _eq(got[0][k], ref[0][k])
    for g, r in zip(got[1:], ref[1:]):
        assert np.asarray(g).dtype == np.asarray(r).dtype
        _eq(g, r)


@pytest.mark.parametrize("quality", [0, 10, 50, 75, 90, 99, 100])
def test_rd_params_equal_reference(quality):
    qp, lam = FP.rd_params(quality)
    qp_r, lam_r = FP_ref.rd_params(quality)
    assert lam == lam_r
    for k in ("y1", "y2", "uv"):
        for a, b in zip(qp[k], qp_r[k]):
            _eq(a.numpy(), b)


def test_rate_tables_equal_reference():
    rt = FP.RateTables(np.asarray(T.COEFFS_PROBA0))
    rt_r = FP_ref.RateTables(np.asarray(T_ref.COEFFS_PROBA0))
    for f in ("lvl", "tail", "eob", "lvlp", "tailp", "eob1p", "eob2p",
              "emptyp"):
        _eq(getattr(rt, f), getattr(rt_r, f))


def test_tables_from_numpy_of_reference_tables_equal_ports_own():
    """The reference's numpy tables, moved to the device, are exactly the
    port's own device tables."""
    ref = FP.tables_from_numpy(FP_ref.all_q_tables(),
                               FP_ref.RateTables(np.asarray(
                                   T_ref.COEFFS_PROBA0)), "cpu")
    own = FP.device_tables("cpu")
    for k in ("y1", "y2", "uv"):
        assert torch.equal(ref.q[k], own.q[k])
    for f in ("lam_i16", "lam_uv", "lam_i4", "lam_mode", "qi4",
              "rate_consts"):
        assert getattr(ref, f).dtype == getattr(own, f).dtype
        assert torch.equal(getattr(ref, f), getattr(own, f)), f
    _eq(own.lam_mode.numpy(),
        FP_ref._lam_mode_table(FP_ref.all_q_tables()[4]))


@pytest.mark.parametrize("quality,sns", [(75, 50), (10, 100), (95, 20),
                                         (50, 0)])
def test_sns_curve_every_alpha_equals_reference_pow(quality, sns):
    """The SNS quant curve, evaluated once per alpha_n in -127..127, equals
    the reference's float32 jnp.power formula on its whole domain."""
    from webp_tpu.lossy.analysis import _quality_to_compression

    alpha_n = jnp.arange(-127, 128, dtype=jnp.int32)
    amp = 0.9 * sns / 100.0 / 128.0
    c = jnp.power(jnp.float32(float(_quality_to_compression(quality))),
                  1.0 - amp * alpha_n.astype(jnp.float32))
    ref = jnp.clip((127.0 * (1.0 - c)).astype(jnp.int32), 0, 127)
    _eq(FP.sns_qidx_table(quality, sns).numpy(), ref)


@pytest.mark.parametrize("sns", [0, 30, 50, 100])
def test_uv_deltas_and_rows_equal_reference(sns):
    rng = np.random.default_rng(sns)
    guv = rng.integers(0, 256, (3,), np.int32)
    q_idx = rng.integers(0, 128, (3, 4), np.int32)
    dc, ac = FP._uv_deltas(torch.as_tensor(guv), sns)
    dc_r, ac_r = FP_ref._uv_deltas(jnp.asarray(guv), sns)
    assert dc == dc_r
    _eq(ac.numpy(), ac_r)
    rows = FP._uv_rows_delta(torch.as_tensor(q_idx), dc, ac,
                             FP.device_tables("cpu"))
    rows_r = FP_ref._uv_rows_delta(jnp.asarray(q_idx), dc_r, ac_r)
    _eq(rows.numpy(), rows_r)
    _eq(FP._lam_uv_of(rows).numpy(), FP_ref._lam_uv_of(rows_r))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plan_from_histo_equals_reference(seed):
    import jax

    rng = np.random.default_rng(seed)
    B, n_mb = 3, 40
    lo = rng.integers(0, 200, (B, 1))
    alphas = np.clip(lo + rng.integers(0, 56, (B, n_mb)), 0, 255) \
        .astype(np.int32)
    alphas[1] = 17                                   # one-valued histogram
    histo = np.stack([np.bincount(a, minlength=256) for a in alphas]) \
        .astype(np.int32)
    got = FP._plan_from_histo(torch.as_tensor(histo), torch.as_tensor(alphas),
                              75, 50, 4)
    ref = jax.vmap(lambda h, a: FP_ref._plan_from_histo(h, a, 75, 50, 4))(
        jnp.asarray(histo), jnp.asarray(alphas))
    for g, r in zip(got, ref):
        _eq(g.numpy(), r)


def test_tlsd_from_seg_equals_reference():
    rng = np.random.default_rng(5)
    seg_q = rng.integers(0, 128, (4,), np.int32)
    seg_map = rng.integers(0, 4, (30,), np.int32)
    t4, t = FP._tlsd_from_seg(50, torch.as_tensor(seg_q),
                              torch.as_tensor(seg_map))
    t4_r, t_r = FP_ref._tlsd_from_seg(50, jnp.asarray(seg_q),
                                      jnp.asarray(seg_map))
    _eq(t4.numpy(), t4_r)
    _eq(t.numpy(), t_r)
    assert FP._tlsd_from_seg(0, torch.as_tensor(seg_q),
                             torch.as_tensor(seg_map)) == (None, None)


# ---------------------------------------------------------------------------
# Isolation: the port stands alone.
# ---------------------------------------------------------------------------

def _port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for top in (PKG, os.path.join(ROOT, "tools")):
        out += _py_files(top)
    return out


def _py_files(top):
    out = []
    for d, _, files in os.walk(top):
        if "_build" in d or "__pycache__" in d:
            continue
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return out


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|webp_tpu|PIL)\b(?!_torch)|"
    r"from\s+(jax|webp_tpu|PIL)\b(?!_torch)[\w.]*\s+import)", re.M)


def _native_sources():
    out = []
    for sub in ("native/src", "csrc"):
        d = os.path.join(PKG, sub)
        out += [os.path.join(d, f) for f in sorted(os.listdir(d))]
    return out


# Where the port may import Pillow, and how: the Pillow plugin is Pillow
# by nature ("module": anywhere in the file), and the command line tool
# imports it inside the functions that read or write JPEG and GIF
# ("function": indented imports only; PNG needs no Pillow, so the CLI
# runs on a machine without it). jax and webp_tpu have no exception.
_PIL_EXCEPTIONS = {os.path.join("webp_tpu_torch", "pil_plugin.py"): "module",
                   os.path.join("webp_tpu_torch", "cli.py"): "function"}


def _offenders(rel, text):
    out = []
    for m in _FORBIDDEN.finditer(text):
        line = m.group(0)
        allowed = _PIL_EXCEPTIONS.get(rel)
        if re.search(r"\bPIL\b", line) and (
                allowed == "module"
                or allowed == "function" and line[:1].isspace()):
            continue
        out.append(f"{rel}: {line.strip()}")
    return out


def test_port_sources_import_neither_jax_nor_the_reference():
    offenders = []
    for path in _port_sources():
        with open(path) as f:
            text = f.read()
        offenders += _offenders(os.path.relpath(path, ROOT), text)
    assert not offenders, offenders


def test_pil_exceptions_are_the_plugin_and_the_clis_function_imports():
    """The scan's exceptions are exactly two: Pillow anywhere in the
    plugin, Pillow in indented imports of the CLI. jax and webp_tpu are
    forbidden in both, and a module-level PIL import in the CLI or a PIL
    import anywhere else is caught."""
    assert _PIL_EXCEPTIONS == {
        os.path.join("webp_tpu_torch", "pil_plugin.py"): "module",
        os.path.join("webp_tpu_torch", "cli.py"): "function"}
    plugin, cli = _PIL_EXCEPTIONS
    assert not _offenders(plugin, "from PIL import Image, ImageFile\n")
    assert not _offenders(cli, "def f():\n    from PIL import Image\n")
    for rel, text in ((cli, "from PIL import Image\n"),
                      (cli, "import PIL\n"),
                      (os.path.join("webp_tpu_torch", "encoder.py"),
                       "    from PIL import Image\n"),
                      (plugin, "import jax\n"),
                      (plugin, "import webp_tpu\n"),
                      (cli, "    from webp_tpu import encode\n"),
                      (cli, "    import jax.numpy as jnp\n")):
        assert _offenders(rel, text), (rel, text)
    for rel in _PIL_EXCEPTIONS:
        assert os.path.join(ROOT, rel) in _port_sources()


def test_scans_reach_mux_animation_and_metrics():
    """The isolation and environment scans cover the animation slice's
    modules, with no exception for them."""
    rel = {os.path.relpath(p, PKG) for p in _port_sources()}
    assert {os.path.join("mux", "mux.py"),
            os.path.join("animation", "animation.py"),
            os.path.join("ops", "metrics.py")} <= rel


def test_scans_reach_the_band_encoders_and_the_oracle():
    """The isolation and environment scans cover the band encoders'
    package and the wavefront oracle, with no exception for them."""
    rel = {os.path.relpath(p, PKG) for p in _port_sources()}
    assert {os.path.join("parallel", "__init__.py"),
            os.path.join("parallel", "mesh.py"),
            os.path.join("parallel", "exact.py"),
            os.path.join("ops", "wavefront.py")} <= rel


def test_forbidden_import_pattern_catches_offenders():
    """The isolation scan's own check: it flags each form of import it
    must, and none of the port's own."""
    bad = ["import jax", "import jax.numpy as jnp", "from jax import lax",
           "import webp_tpu", "from webp_tpu.ops import fastpath",
           "  from webp_tpu import encode", "import PIL",
           "from PIL import Image", "    from PIL.Image import open"]
    good = ["import webp_tpu_torch", "from webp_tpu_torch.ops import cuda",
            "import jaxlib_free_module", "# import jax"]
    assert all(_FORBIDDEN.search(s) for s in bad)
    assert not any(_FORBIDDEN.search(s) for s in good)


def test_port_reads_no_reference_env_knobs():
    """rd_drop is an argument, the UV dq_ac delta is an argument (uv_ac),
    nothing switches a kernel off: the port reads none of the reference's
    env switches, and no environment at all from Python."""
    knobs = ("WEBPTPU_RD_DROP", "WEBPTPU_DQUV_AC", "WEBPTPU_NO_PALLAS",
             "WEBPTPU_NO_P1K", "WEBPTPU_P2K", "WEBPTPU_NO_PLANAR",
             "WEBPTPU_PY_LOOP", "WEBPTPU_VP8L_DEVICE")
    for path in _port_sources():
        with open(path) as f:
            text = f.read()
        for k in knobs:
            assert k not in text, (path, k)
        assert "os.environ" not in text and "getenv" not in text, path


def test_native_and_cuda_sources_read_no_environment():
    """The port's C++ and CUDA sources read no environment variable (the
    reference's copies read WEBPTPU_LZ_ITER, WEBPTPU_NO_TRACE,
    WEBPTPU_MB_PROF and others; its WEBPTPU_*_SIMD macros are compile-time
    switches, not names of variables)."""
    srcs = _native_sources()
    assert any(p.endswith("vp8l_enc.cc") for p in srcs)
    for path in srcs:
        with open(path) as f:
            text = f.read()
        assert "getenv" not in text and '"WEBPTPU_' not in text, path


def test_package_imports_without_jax_triton_or_nvcc():
    """Every module of the package imports in a process where jax and
    triton cannot be imported and no CUDA toolkit is on the path."""
    mods = ["webp_tpu_torch"]
    for d, _, files in os.walk(PKG):
        if "_build" in d or "__pycache__" in d:
            continue
        rel = os.path.relpath(d, ROOT).replace(os.sep, ".")
        mods += [f"{rel}.{f[:-3]}" for f in files
                 if f.endswith(".py") and f != "__init__.py"]
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'triton', 'webp_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'triton') and sys.modules[m] is not None]\n"
        "print('ok')\n")
    env = dict(os.environ, PATH="/usr/bin:/bin")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")


def test_native_coder_is_the_ports_own_build():
    """The copied host coder loads the port's own g++ build from the
    package's gitignored build directory, never the reference's
    webp_tpu/native/libwebptpu.so."""
    from webp_tpu_torch import _build
    from webp_tpu_torch.lossy import encode as E
    from webp_tpu_torch.native import api

    lib = api.get()
    path = os.path.realpath(lib._name)
    assert path == os.path.realpath(_build.lib_path("webp_enc"))
    assert path.startswith(os.path.realpath(_build.BUILD_DIR) + os.sep)
    assert "libwebptpu" not in path
    for name in ("vp8_code_frame", "vp8_encode_mbs", "vp8_write_partition0"):
        assert hasattr(lib, name)
    for lib, name, syms in ((api.get_vp8l(), "vp8l_enc",
                             ("vp8l_encode_entropy_image",
                              "vp8l_predictor_transform",
                              "vp8l_cross_color")),
                            (api.get_dec(), "webp_dec", ("vp8l_decode",))):
        path = os.path.realpath(lib._name)
        assert path == os.path.realpath(_build.lib_path(name))
        assert all(hasattr(lib, s) for s in syms)
    import inspect

    src = inspect.getsource(E)
    assert "from ..native import api" in src and "webp_tpu.native" not in src


@pytest.mark.parametrize("with_dq", [False, True])
def test_mb_quant_equals_reference(with_dq):
    rng = np.random.default_rng(8)
    seg_q = rng.integers(0, 128, (4,)).astype(np.int32)
    seg_map = rng.integers(0, 4, (20,)).astype(np.int32)
    dq = (-2, np.int32(3)) if with_dq else None
    qp, lam, rows = FP._mb_quant(
        torch.as_tensor(seg_map), torch.as_tensor(seg_q), 20,
        dq_uv=None if dq is None else (dq[0], torch.as_tensor(dq[1])))
    qp_r, lam_r, rows_r = FP_ref._mb_quant(
        jnp.asarray(seg_map), jnp.asarray(seg_q), 20,
        dq_uv=None if dq is None else (dq[0], jnp.asarray(dq[1])))
    for k in ("y1", "y2", "uv"):
        _eq(rows[k].numpy(), rows_r[k])
        for a, b in zip(qp[k], qp_r[k]):
            _eq(a.numpy(), b)
    assert set(lam) == set(lam_r)
    for k in lam:
        _eq(lam[k].numpy(), lam_r[k])


@pytest.mark.parametrize("sns,q_i4", [(50, 30), (0, 30), (1, 10)])
def test_tlsd_static_equals_reference(sns, q_i4):
    got = FP._tlsd_static(sns, q_i4, 12)
    ref = FP_ref._tlsd_static(sns, q_i4, 12)
    if ref[0] is None:
        assert got == (None, None)
    else:
        _eq(got[0].numpy(), ref[0])
        _eq(got[1].numpy(), ref[1])


def test_animation_module_loads_neither_jax_nor_pil():
    """Importing the port's animation module (and with it mux and
    ops/metrics) in a fresh process loads neither jax nor PIL, nor the
    reference package."""
    code = ("import sys\n"
            "import webp_tpu_torch.animation.animation\n"
            "import webp_tpu_torch.mux.mux\n"
            "import webp_tpu_torch.ops.metrics\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'PIL', 'webp_tpu'}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"
