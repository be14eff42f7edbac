"""The port's native data path (``fia_tpu_torch/data/native.py``): its
own build of ``native/fia_native.cpp``, the parse and the CSR against the
numpy fallback and against the reference's native module, and the
fallback switch. Restates ``tests/test_native.py`` against the port."""

import os

import numpy as np
import pytest
import torch

from fia_tpu.data import native as ref_native
from fia_tpu_torch.data import index as port_index
from fia_tpu_torch.data import native

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(REPO, "native")


@pytest.fixture(scope="module")
def built():
    try:
        native.build()
    except RuntimeError as e:
        pytest.skip(f"native build failed: {str(e)[:200]}")
    assert native.available()
    return True


def _ratings(tmp_path, n=1000, seed=0):
    rng = np.random.default_rng(seed)
    rows = np.stack([rng.integers(0, 500, n), rng.integers(0, 300, n),
                     rng.integers(1, 6, n)], axis=1)
    p = tmp_path / "r.rating"
    np.savetxt(p, rows, fmt="%d", delimiter="\t")
    return str(p), rows


class TestNative:
    def test_parse_tsv_matches_loadtxt(self, built, tmp_path):
        p, rows = _ratings(tmp_path)
        u, i, r = native.parse_tsv(p)
        assert np.array_equal(u, rows[:, 0]) and np.array_equal(i, rows[:, 1])
        np.testing.assert_allclose(r, rows[:, 2])

    def test_parse_tsv_decimal_and_maxrows(self, built, tmp_path):
        p = tmp_path / "r.rating"
        p.write_text("0\t1\t3.5\n2\t3\t4.25\n4\t5\t1\n")
        u, i, r = native.parse_tsv(str(p), max_rows=2)
        assert u.tolist() == [0, 2] and i.tolist() == [1, 3]
        np.testing.assert_allclose(r, [3.5, 4.25])

    def test_parse_tsv_skips_header_lines(self, built, tmp_path):
        """Non-numeric lines (headers, comments) are skipped, not parsed
        into spurious (0, 0, 0.0) rows."""
        p = tmp_path / "h.rating"
        p.write_text("user\titem\trating\n1\t2\t5\n# comment\n3\t4\t2.5\n")
        u, i, r = native.parse_tsv(str(p))
        np.testing.assert_array_equal(u, [1, 3])
        np.testing.assert_array_equal(i, [2, 4])
        np.testing.assert_allclose(r, [5.0, 2.5])

    def test_build_csr_matches_numpy(self, built):
        rng = np.random.default_rng(1)
        ids = rng.integers(0, 50, 5000).astype(np.int32)
        indptr, indices = native.build_csr(ids, 50)
        order = np.argsort(ids, kind="stable")
        counts = np.bincount(ids, minlength=50)
        want_indptr = np.zeros(51, np.int64)
        np.cumsum(counts, out=want_indptr[1:])
        assert np.array_equal(indptr, want_indptr)
        assert np.array_equal(indices, order)

    def test_build_csr_out_of_range(self, built):
        with pytest.raises(ValueError):
            native.build_csr(np.array([0, 7], np.int32), 5)

    def test_loader_uses_native(self, built, tmp_path, monkeypatch):
        from fia_tpu_torch.data.loaders import _read_tsv

        calls = []
        real = native._load
        monkeypatch.setattr(native, "_load",
                            lambda: calls.append(1) or real())
        p = tmp_path / "x.rating"
        p.write_text("0\t0\t5\n1\t1\t3\n")
        ds = _read_tsv(str(p), None)
        assert ds.num_examples == 2
        assert ds.y.tolist() == [5.0, 3.0]
        assert calls and real() is not None


def test_build_writes_nothing_under_native(tmp_path, monkeypatch):
    """A fresh build goes to the port's build directory under a per-pid
    temporary name, renamed into place; the compiler reads
    ``native/fia_native.cpp`` and writes nothing under ``native/``, and
    the library loaded is the port's, never ``native/libfia_native.so``."""
    import subprocess

    build_dir = tmp_path / "_build"
    monkeypatch.setattr(native, "BUILD_DIR", str(build_dir))
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    cmds, loaded = [], []
    real_run = subprocess.run
    monkeypatch.setattr(native.subprocess, "run",
                        lambda cmd, **kw: cmds.append(cmd) or real_run(cmd,
                                                                       **kw))
    real_cdll = native.ctypes.CDLL
    monkeypatch.setattr(native.ctypes, "CDLL",
                        lambda path: loaded.append(path) or real_cdll(path))
    before = sorted(os.listdir(NATIVE_DIR))
    if not native.available():
        pytest.skip("no C++ compiler for the native library")
    (cmd,) = cmds
    out = cmd[cmd.index("-o") + 1]
    assert os.path.dirname(out) == str(build_dir)
    assert out.endswith(f".{os.getpid()}.tmp")
    assert native.SOURCE == os.path.join(NATIVE_DIR, "fia_native.cpp")
    assert cmd[-1] == native.SOURCE
    assert [a for a in cmd[:-1] if a.startswith(NATIVE_DIR)] == []
    assert loaded == [native.library_path()]
    assert os.path.dirname(loaded[0]) == str(build_dir)
    assert sorted(os.listdir(build_dir)) == [
        os.path.basename(native.library_path())]
    # nothing the port names is left under native/ (a reference build of
    # libfia_native.so by its own tests may come and go meanwhile)
    after = sorted(os.listdir(NATIVE_DIR))
    assert [f for f in after if f not in before
            and f != "libfia_native.so"] == []


def test_library_name_keys_source_flags_and_cpu(monkeypatch):
    base = native.library_path()
    monkeypatch.setattr(native, "_host_cpu", lambda: "x86_64|another|cpu")
    assert native.library_path() != base
    monkeypatch.undo()
    monkeypatch.setenv("CXX", "clang++")
    assert native.library_path() != base


def test_port_matches_reference_native_and_numpy(built, tmp_path):
    """The port's parse and CSR equal the reference's native module's and
    the numpy fallback's, array for array."""
    p, _ = _ratings(tmp_path, n=3000, seed=4)
    got = native.parse_tsv(p, max_rows=2500)
    for want in (ref_native.parse_tsv(p, max_rows=2500),
                 native.parse_tsv_numpy(p, max_rows=2500)):
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    ids = got[0]
    csr = native.build_csr(ids, 500)
    for want in (ref_native.build_csr(ids, 500),
                 native.build_csr_numpy(ids, 500)):
        for a, b in zip(csr, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    # the index's postings are the native CSR
    x = np.stack([got[0], got[1]], axis=1)
    ix = port_index.InteractionIndex(x, 500, 300)
    u_indptr, u_rows, i_indptr, i_rows = ix.postings()
    assert np.array_equal(u_indptr, csr[0]) and np.array_equal(u_rows, csr[1])
    want_i = native.build_csr_numpy(got[1], 300)
    assert np.array_equal(i_indptr, want_i[0])
    assert np.array_equal(i_rows, want_i[1])


def test_fia_native_0_takes_the_numpy_path(tmp_path, monkeypatch):
    p, rows = _ratings(tmp_path, n=200, seed=5)
    monkeypatch.setenv("FIA_NATIVE", "0")
    assert not native.available()
    seen = []
    for name in ("parse_tsv_numpy", "build_csr_numpy"):
        real = getattr(native, name)
        monkeypatch.setattr(native, name,
                            lambda *a, _r=real, _n=name, **k:
                            seen.append(_n) or _r(*a, **k))
    u, i, r = native.parse_tsv(p)
    indptr, indices = native.build_csr(u, 500)
    assert seen == ["parse_tsv_numpy", "build_csr_numpy"]
    assert np.array_equal(u, rows[:, 0]) and np.array_equal(i, rows[:, 1])
    assert np.array_equal(indices, np.argsort(u, kind="stable"))
