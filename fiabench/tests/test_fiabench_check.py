"""How ``correct`` is decided: a whole run on the CPU at a tiny size
passes; its control (the reference one precision down) fails the cell's
limits; and a run whose timed path is broken underneath comes out not
correct, for each fault a cell of this benchmark can have."""

import numpy as np
import pytest
import torch

from fiabench import cell, check, precision

CELLS = ["mf-k16-ml1m.uniform4k", "ncf-k16-ml1m.uniform4k",
         "ncf-k16-ml1m.mesh4-uniform16k", "mf-k16-ml1m.popular2k"]


def test_round_tf32():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12,
                      -(1.0 + 3 * 2.0 ** -12)], dtype=torch.float32)
    got = precision.round_tf32(x)
    want = [1.0, 1.0 + 2.0 ** -10, 1.0, -(1.0 + 2.0 ** -10)]
    assert got.tolist() == want


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct_and_its_control_is_not(tiny, name):
    out, (cfg, params, ratings, sample) = cell.run(
        tiny, name, 2 ** 31 + 3, 1.0, False, "cpu", keep=True)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    ctrl = check.compare(cfg, params, ratings, sample, "cpu",
                         precision="tf32")
    ctrl["nonfinite"] = 0
    ok, checks = check.judge(ctrl, check.load_limits(name))
    assert not ok, checks


def _halve_rows(monkeypatch):
    """Every other flat row left out of the Hessian sums, the mean
    taken over the rest."""
    from fia_tpu_torch.influence.kernels import segment

    real = segment.segment_sums_reference

    def halved(g, t, wv, abe, T, chunk, **kw):
        keep = torch.arange(wv.shape[0]) % 2 == 0
        HH, sabe = real(g, t, wv * keep, abe * keep, T, chunk, **kw)
        return 2 * HH, 2 * sabe

    monkeypatch.setattr(segment, "segment_sums_reference", halved)


def _alter_answers(monkeypatch):
    """One score of every 16 altered where the score stage makes it."""
    from fia_tpu_torch.influence import kernels

    real = kernels.fused_scores

    def altered(*args):
        s = real(*args).clone()
        s[::16] *= 1.01
        return s

    monkeypatch.setattr(kernels, "fused_scores", altered)


def _drop_exchange(monkeypatch):
    """The last card's shard never reaches the host: its outputs stay
    zero."""
    from fia_tpu_torch.influence.engine import InfluenceEngine

    real = InfluenceEngine._collect

    def dropped(self, outs):
        parts = real(self, outs)
        if len(parts) > 1:
            parts[-1] = [np.zeros_like(a) for a in parts[-1]]
        return parts

    monkeypatch.setattr(InfluenceEngine, "_collect", dropped)


FAULTS = [("mf-k16-ml1m.uniform4k", _halve_rows),
          ("ncf-k16-ml1m.uniform4k", _halve_rows),
          ("mf-k16-ml1m.popular2k", _halve_rows),
          ("mf-k16-ml1m.uniform4k", _alter_answers),
          ("ncf-k16-ml1m.uniform4k", _alter_answers),
          ("mf-k16-ml1m.popular2k", _alter_answers),
          ("ncf-k16-ml1m.mesh4-uniform16k", _alter_answers),
          ("ncf-k16-ml1m.mesh4-uniform16k", _halve_rows),
          ("ncf-k16-ml1m.mesh4-uniform16k", _drop_exchange)]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{n}-{f.__name__[1:]}" for n, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, name, fault):
    fault(monkeypatch)
    out = cell.run(tiny, name, 2 ** 31 + 4, 1.0, False, "cpu")
    assert not out["correct"], out["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(spec, name):
    """The control on the card at the cell's own size (calibrate.py's
    readings, one seed)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    chips = spec.workload(name)["chips"]
    if torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} CUDA cards")
    out, (cfg, params, ratings, sample) = cell.run(
        spec, name, 2 ** 31 + 9, 2.0, False, "cuda", keep=True)
    assert out["correct"], out["checks"]
    ctrl = check.compare(cfg, params, ratings, sample, "cuda:0",
                         precision="tf32")
    ctrl["nonfinite"] = 0
    assert not check.judge(ctrl, check.load_limits(name))[0]
