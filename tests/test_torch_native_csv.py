"""The port's native CSV reader (``data/native.py`` over
``csrc/csvloader.cpp``) against the JAX package's ``load_csv_native`` on the
same files: the committed CSV and the JAX tests' fixtures (scientific
notation, CRLF, no trailing newline, blank lines, NaN/inf through
``strtof``, ragged and empty-field rejection) and an 18-significant-digit
fixture. Values are bitwise equal to the JAX reader's and within 1 ulp of
``np.loadtxt(float64).astype(float32)``; ``NATIVE_CSV=0`` takes
``np.loadtxt``; a failed build or load raises."""

import os

import numpy as np
import pytest
import torch

from fraud_detection_tpu.data import native as jax_native
from fraud_detection_tpu.data.loader import load_creditcard_csv as jax_load
from fraud_detection_tpu_torch.data import native
from fraud_detection_tpu_torch.data.loader import load_creditcard_csv

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSV = os.path.join(ROOT, "data", "creditcard.csv")


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    """Largest distance in float32 units in the last place (finite
    values; NaN against NaN counts 0)."""
    a = np.asarray(a, np.float32).ravel()
    b = np.asarray(b, np.float32).ravel()
    both_nan = np.isnan(a) & np.isnan(b)
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    # map to a monotone integer line across the sign
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    d = np.where(both_nan, 0, np.abs(ia - ib))
    return int(d.max()) if d.size else 0


def _loadtxt32(path) -> np.ndarray:
    return np.loadtxt(path, delimiter=",", skiprows=1, dtype=np.float64,
                      ndmin=2).astype(np.float32)


def eighteen_digit_csv(path, rows: int = 400, cols: int = 31, seed: int = 0) -> None:
    """Values written with 16 to 18 significant digits (the real Kaggle
    file writes up to 18), a decimal point at a random place."""
    rng = np.random.default_rng(seed)
    lines = [",".join(f"c{j}" for j in range(cols))]
    for _ in range(rows):
        fields = []
        for _ in range(cols):
            digits = int(rng.integers(16, 19))
            mant = "".join(str(int(c)) for c in rng.integers(0, 10, digits))
            mant = str(int(rng.integers(1, 10))) + mant[1:]
            point = int(rng.integers(1, digits))
            sign = "-" if rng.random() < 0.5 else ""
            fields.append(f"{sign}{mant[:point]}.{mant[point:]}")
        lines.append(",".join(fields))
    path.write_text("\n".join(lines) + "\n")


FIXTURES = {
    "sci": "a,b,Class\n-1.5e-3,2.25E+2,1\n0.0,-3,0\n",
    "no_trailing_newline": "a,Class\n1.0,0\n2.0,1",
    "blank_lines": "a,Class\n1.0,0\n2.0,1\n\n",
    "crlf": "a,Class\r\n1.5,0\r\n2.5,1\r\n",
    "nan_inf": "a,b\nnan,inf\n-inf,1.0\n",
    "quoted_names": '"a","b c",Class\n1.25,2,0\n',
}
REJECTED = {
    "ragged": "a,Class\n1.0,0,999\n",
    "empty_field": "a,b\n1.0,\n2.0,3.0\n",
    "malformed": "a,b,Class\n1.0,oops,0\n",
}


def test_committed_csv_is_bitwise_the_jax_reader_and_within_one_ulp():
    got, names = native.load_csv_native(CSV)
    want, jnames = jax_native.load_csv_native(CSV)
    assert names == jnames and got.shape == want.shape == (20000, 31)
    assert got.tobytes() == want.tobytes()
    assert _ulps(got, _loadtxt32(CSV)) <= 1


def test_loader_matches_jax_loader_on_committed_csv(monkeypatch):
    monkeypatch.delenv("NATIVE_CSV", raising=False)
    x, y, names = load_creditcard_csv(CSV)
    jx, jy, jnames = jax_load(CSV)
    assert names == jnames
    assert x.tobytes() == jx.tobytes() and np.array_equal(y, jy)
    assert x.dtype == np.float32 and y.dtype == np.int32


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixtures_bitwise_the_jax_reader(name, tmp_path):
    path = tmp_path / f"{name}.csv"
    path.write_bytes(FIXTURES[name].encode())
    got = native.load_csv_native(str(path))
    want = jax_native.load_csv_native(str(path))
    assert got is not None and want is not None
    assert got[1] == want[1]
    assert got[0].tobytes() == want[0].tobytes()
    if name != "quoted_names":
        assert _ulps(got[0], _loadtxt32(path)) <= 1


@pytest.mark.parametrize("name", sorted(REJECTED))
def test_rejected_files_fall_through_counted(name, tmp_path, monkeypatch, caplog):
    path = tmp_path / f"{name}.csv"
    path.write_text(REJECTED[name])
    assert jax_native.load_csv_native(str(path)) is None
    before = native.NATIVE_CSV_FALLBACKS
    with caplog.at_level("WARNING", logger="fraud_detection_tpu_torch.native"):
        assert native.load_csv_native(str(path)) is None
    assert native.NATIVE_CSV_FALLBACKS == before + 1
    assert "rejected" in caplog.text
    # the loader takes the plain version, which refuses such a file too
    monkeypatch.delenv("NATIVE_CSV", raising=False)
    with pytest.raises(ValueError):
        load_creditcard_csv(str(path))
    assert native.NATIVE_CSV_FALLBACKS == before + 2


def test_eighteen_digit_values_equal_jax_and_within_one_ulp_of_loadtxt(tmp_path):
    path = tmp_path / "digits18.csv"
    eighteen_digit_csv(path)
    got, _ = native.load_csv_native(str(path))
    want, _ = jax_native.load_csv_native(str(path))
    assert got.tobytes() == want.tobytes()
    plain = _loadtxt32(path)
    assert _ulps(got, plain) <= 1
    # 16-18 digits: the int64 → double step may round, so some values may
    # land 1 ulp away; the count is reported by chip_smoke.py phase 10
    assert int((got != plain).sum()) < got.size // 10


def test_native_csv_zero_takes_loadtxt(tmp_path, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the native reader ran under NATIVE_CSV=0")

    monkeypatch.setattr(native, "load_csv_native", refuse)
    monkeypatch.setenv("NATIVE_CSV", "0")
    x, y, names = load_creditcard_csv(CSV)
    assert x.shape == (20000, 30) and len(names) == 30
    jx, jy, _ = jax_load(CSV)
    assert _ulps(x, jx) <= 1 and np.array_equal(y, jy)


@pytest.mark.parametrize("value", ["0", "1", "", "false", "no"])
def test_native_csv_setting_follows_the_jax_loader(value, tmp_path, monkeypatch):
    """JAX reads NATIVE_CSV at its loader: only "0" skips its reader."""
    from fraud_detection_tpu_torch import config

    calls = []
    real = jax_native.load_csv_native

    def spy(path, *a, **k):
        calls.append(path)
        return real(path, *a, **k)

    monkeypatch.setattr(jax_native, "load_csv_native", spy)
    monkeypatch.setenv("NATIVE_CSV", value)
    path = tmp_path / "t.csv"
    path.write_text("a,Class\n1.0,0\n2.0,1\n")
    try:
        jax_load(str(path))
    except ImportError:  # pandas absent: only the plain path needs it
        assert not calls
    assert config.native_csv() == bool(calls)


def test_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="build failed"):
        native.load_csv_native(CSV)
    assert not list((tmp_path / "build").glob("*.so"))


def test_failed_dlopen_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    (tmp_path / "build").mkdir()
    native.library_path().write_bytes(b"not a shared object")
    with pytest.raises(OSError):
        native.load_csv_native(CSV)


def test_build_lands_in_the_ports_build_dir(tmp_path, monkeypatch):
    """A fresh build goes to the port's build directory through a
    PID-unique temporary, never into the JAX package's native/build."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    out = native.build()
    assert out.parent == tmp_path / "build" and out.exists()
    assert not list((tmp_path / "build").glob("*.tmp"))
    got, _ = native.load_csv_native(CSV)
    assert got.shape == (20000, 31)
    assert "fraud_detection_tpu/native" not in str(native.library_path())
