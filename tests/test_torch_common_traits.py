"""tpukk_torch.common's arithmetic traits, controls, configuration dump,
eager initialisation, performance archive and tracing regions against
tpukk's on the same inputs, on the CPU.  Mirrors tests/test_common.py
(test_arith_traits, test_controls_mapping,
test_print_configuration_and_eager_init, test_perf_archive) and
tests/test_tracing.py (test_region_name_format,
test_profile_region_nests_and_is_jit_safe, and the instrumentation of
spmv_struct's public functions).

Tolerance: exact (the traits are constants; the element functions compute
the same IEEE operations), but the modulus of a complex value and the square
root of that modulus, library functions in both packages, within 2 eps.
"""
import importlib
import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpukk.common as jcommon
import tpukk.sparse as jsparse
import tpukk_torch
import tpukk_torch.common as tcommon
import tpukk_torch.sparse as tsparse
from tpukk_torch import _kernels
from tpukk_torch.common import TpuKKError

DTYPES = [  # (numpy or jnp dtype for tpukk, torch dtype for the port)
    (np.float32, torch.float32), (np.float64, torch.float64), (np.float16, torch.float16),
    (jnp.bfloat16, torch.bfloat16), (np.int32, torch.int32), (np.int64, torch.int64),
    (np.uint8, torch.uint8), (np.complex64, torch.complex64), (np.complex128, torch.complex128),
]
_TO_TORCH = {np.dtype(j): t for j, t in DTYPES}


def _np(t):
    t = t.detach().cpu()
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=[str(t)[6:] for _, t in DTYPES])
def test_arith_traits_match_tpukk(jdt, tdt):
    jt = jcommon.arith_traits(jdt)
    for key in (tdt, *([jdt] if jdt is not jnp.bfloat16 else [])):
        tt = tcommon.arith_traits(key)
        assert tt is tcommon.arith_traits(tdt)  # numpy and torch keys share one entry
    assert tt.dtype == tdt
    assert tt.eps == jt.eps
    assert (tt.is_integer, tt.is_complex) == (jt.is_integer, jt.is_complex)
    assert tt.mag_dtype == _TO_TORCH[np.dtype(jt.mag_dtype)]
    assert tcommon.mag_dtype(tdt) == tt.mag_dtype
    assert tcommon.is_complex(tdt) == jcommon.is_complex(jdt) == tt.is_complex
    # tpukk's min/max go through np.finfo, which has no bf16: jnp.finfo there
    lim = jnp.finfo(jdt) if jdt is jnp.bfloat16 else jt
    assert (float(tt.min), float(tt.max)) == (float(lim.min), float(lim.max))
    assert _np(tt.zero) == np.asarray(jt.zero) and _np(tt.one) == np.asarray(jt.one)
    # the element functions on the same values
    rng = np.random.default_rng(3)
    raw = rng.standard_normal(7) * 4 + (1j * rng.standard_normal(7) if tt.is_complex else 0)
    if tt.is_integer:
        raw = np.abs(raw).round()
    xj = jnp.asarray(raw.astype(np.dtype(jdt)) if jdt is not jnp.bfloat16 else raw, dtype=jdt)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32) if jdt is jnp.bfloat16 else xj)
                          ).to(tdt)
    # a complex modulus and a square root of one are library functions (hypot)
    # in XLA and in torch: within 2 eps of each other, the rest exactly
    rtol = 2 * tt.eps if tt.is_complex else 0.0
    for fn in ("abs", "conj", "real", "imag", "isnan"):
        got, want = _np(getattr(tt, fn)(xt)), np.asarray(getattr(jt, fn)(xj))
        want = want.astype(np.float32) if want.dtype == jnp.bfloat16 else want
        np.testing.assert_allclose(got, want, rtol=rtol if fn == "abs" else 0.0, atol=0,
                                   err_msg=fn)
    if not tt.is_integer:
        xa, xja = torch.abs(xt), jnp.abs(xj)
        want = np.asarray(jt.sqrt(xja))
        np.testing.assert_allclose(
            _np(tt.sqrt(xa)), want.astype(np.float32) if want.dtype == jnp.bfloat16 else want,
            rtol=rtol, atol=0)


def test_controls_mapping_matches_tpukk():
    for name in ("default", "auto", "native", "merge", "dia", "ell", "segsum", "dense",
                 "unknown"):
        jc = jcommon.Controls().set("algorithm", name)
        tc = tcommon.Controls().set("algorithm", name)
        assert tc.get("algorithm") == jc.get("algorithm") == name
        assert tc.spmv_algorithm() is getattr(tsparse.SpmvAlgorithm, jc.spmv_algorithm().name)
    assert tcommon.Controls().spmv_algorithm() is tsparse.SpmvAlgorithm.AUTO
    assert tcommon.Controls().get("missing", "x") == jcommon.Controls().get("missing", "x")


def test_print_configuration_names_torch_and_the_device():
    buf = io.StringIO()
    text = tcommon.print_configuration(buf)
    assert buf.getvalue().strip() == text.strip()
    assert f"tpukk_torch version: {tpukk_torch.__version__}" in text
    assert f"torch version: {torch.__version__}" in text and "CUDA version:" in text
    if not torch.cuda.is_available():
        assert "device: cpu" in text
    assert "jax" not in text.lower() and "tpu" not in text.replace("tpukk", "").lower()
    assert "tpukk version" in jcommon.print_configuration()


def test_eager_initialize_on_the_cpu_builds_the_host_planners_only(monkeypatch):
    assert tcommon.eager_initialize(device="cpu") >= 0.0
    assert "host" in _kernels._libs
    assert not any(n in _kernels._libs for n in _kernels.SOURCES)
    assert "host planners (csrc/host.cpp): built" in tcommon.print_configuration()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(TpuKKError, match="device='cpu'"):
        tcommon.eager_initialize()


def test_perf_archive_matches_tpukk(tmp_path):
    runs = [100.0, 105.0, 150.0, 50.0, 100.0]  # new, pass, fail, improved, fail
    statuses = {}
    for pkg, cls in (("tpukk", jcommon.PerfArchive), ("port", tcommon.PerfArchive)):
        path = tmp_path / f"{pkg}.json"
        out = []
        for v in runs:
            r = cls(path, machine="testbox", tolerance=0.1).run_and_compare("spmv", {"time_us": v})
            out.append((r["time_us"].status, r["time_us"].reference, r["time_us"].change))
        statuses[pkg] = out
    assert statuses["port"] == statuses["tpukk"]
    db = json.loads((tmp_path / "port.json").read_text())
    entry = db["testbox::spmv"]
    assert entry["device"] == tcommon.controls.device_description()
    assert all(h["device"] == entry["device"] for h in entry["history"])
    # either package reads the other's archive
    r = jcommon.PerfArchive(tmp_path / "port.json", machine="testbox").run_and_compare(
        "spmv", {"time_us": 50.0})
    assert r["time_us"].status == "pass"
    arch = tcommon.PerfArchive(tmp_path / "tpukk.json", machine="testbox", device="a card")
    res = arch.run_and_compare("spmv", {"time_us": 49.0, "gbps": 1.0})
    assert res["time_us"].status == "pass" and res["gbps"].status == "new"
    assert arch.passed(res)
    assert isinstance(res["gbps"], tcommon.MetricResult)


def test_region_names_match_tpukk():
    # the packages re-export the function spmv_struct under its module's name
    jstruct = importlib.import_module("tpukk.sparse.spmv_struct")
    tstruct = importlib.import_module("tpukk_torch.sparse.spmv_struct")
    assert tcommon.region_name("spmv", "N", "DIA") == jcommon.region_name("spmv", "N", "DIA")
    assert tcommon.region_name("pcg") == jcommon.region_name("pcg") == "tpukk::pcg"
    for name in ("spmv_struct", "structured_stencil_offsets"):
        assert getattr(tstruct, name)._tpukk_region == getattr(jstruct, name)._tpukk_region
        assert getattr(tsparse, name) is getattr(tstruct, name)
        assert hasattr(jsparse, name)


def test_profile_region_nests():
    with tcommon.profile_region("tpukk::outer"):
        with tcommon.profile_region("tpukk::inner"):
            y = torch.ones(8) * 2
    assert float(y[0]) == 2.0


@pytest.mark.parametrize("name", ["ArithTraits", "arith_traits", "is_complex", "mag_dtype",
                                  "Controls", "eager_initialize", "print_configuration",
                                  "MetricResult", "PerfArchive"])
def test_common_exports(name):
    assert hasattr(jcommon, name) and hasattr(tcommon, name)
