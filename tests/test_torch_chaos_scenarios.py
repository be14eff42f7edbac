"""The port's chaos scenarios (``fia_tpu_torch/chaos/scenarios.py``) on
the CPU, one case per smoke scenario, each against the reference's
(``fia_tpu/chaos/scenarios.py``):

- the port's smoke seeds 0 and 1 pass the whole oracle battery, over
  virtual slots for the mesh scenarios, with no ``mesh_skipped`` event;
- benign seed 0 fires the same faults as the reference's run of the
  same schedule (sites, call indices, kinds) and reaches each scheduled
  site as often;
- golden outcomes against the reference's, on the reference's params
  (``jax.random.PRNGKey(0)``, carried across through
  ``params_from_numpy`` by patching the port's ``MF.init_params``) and
  its batch schedules (``epoch_permutation`` patched, as
  ``test_torch_train.py`` does): every status, reason, id, count and
  plan id equal; every array, and every float (bounds, waits), at the
  ROADMAP bar, rtol 2e-5 / atol 1e-6 — but for two scenarios, whose
  bars ROADMAP Queue C states:

  - ``serve_brownout``: the sampled rung's blocks at these untrained
    weights are indefinite or ill-conditioned (cond up to 148), and a
    float32 LU solve's error is normwise, so its arrays are held at
    2e-5 of their largest |entry| plus 1e-6 (measured: 1.5e-6 of it on
    ``a1``, whose smallest entry is 3.0e-4 off relative);
  - ``unlearn_while_serving``: 24 steps of training, two removal and
    reweight fine-tunes and two reverse sweeps in float32 in two
    frameworks, so its arrays are held normwise too (measured 1.3e-5 of
    the largest |entry|) and its predicted deltas, sums over the sweep,
    at rtol 1e-4 (measured 5.2e-5).

The reference runs as its own tests run it: on the CPU with the 8
virtual XLA devices of ``tests/conftest.py``, where its mesh scenarios
build their meshes.
"""

import jax
import numpy as np
import pytest
import torch

from fia_tpu.chaos import ChaosEngine as RefChaosEngine
from fia_tpu.chaos.scenarios import SCENARIO_NAMES as REF_SCENARIO_NAMES
from fia_tpu.cli.chaos import SMOKE_SCENARIOS as REF_SMOKE
from fia_tpu.models import MF as RefMF
from fia_tpu_torch.chaos import ChaosEngine
from fia_tpu_torch.chaos import scenarios as S
from fia_tpu_torch.cli.chaos import SMOKE_SCENARIOS
from fia_tpu_torch.models import MF, params_from_numpy
from fia_tpu_torch.train import trainer as T

torch.set_num_threads(2)

RTOL, ATOL = 2e-5, 1e-6
FAULTS = 3
# scenarios whose arrays are held normwise (ROADMAP Queue C), and the
# floats held at their own rtol
NORMWISE = ("serve_brownout", "unlearn_while_serving")
FLOAT_RTOL = {"predicted_delta1": 1e-4, "predicted_delta2": 1e-4}


def _fit_perm(seed, epoch, n):
    """The reference fit's epoch permutation (trainer.py:118, 243)."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), epoch)
    return torch.from_numpy(np.array(jax.random.permutation(key, n)))


def _ref_params():
    model = RefMF(S._U, S._I, S._K, S._WD)
    return jax.tree_util.tree_map(np.asarray,
                                  model.init_params(jax.random.PRNGKey(0)))


def test_registry_is_the_references():
    assert S.SCENARIO_NAMES == REF_SCENARIO_NAMES
    assert SMOKE_SCENARIOS == REF_SMOKE


def _same_outcome(got: dict, want: dict, name: str) -> None:
    assert sorted(got) == sorted(want), name
    for key in sorted(want):
        g, w = got[key], want[key]
        if isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray), (name, key)
            assert g.dtype == w.dtype and g.shape == w.shape, (name, key)
            if name in NORMWISE and w.size:
                err = np.max(np.abs(g.astype(np.float64) - w))
                assert err <= RTOL * np.max(np.abs(w)) + ATOL, (name, key,
                                                                 err)
            else:
                np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                           err_msg=f"{name}: {key}")
        elif isinstance(w, float):
            assert isinstance(g, float), (name, key)
            rtol = FLOAT_RTOL.get(key, RTOL) if name in NORMWISE else RTOL
            np.testing.assert_allclose(g, w, rtol=rtol, atol=ATOL,
                                       err_msg=f"{name}: {key}")
        else:
            assert type(g) is type(w) and g == w, (name, key, g, w)


@pytest.mark.parametrize("name", SMOKE_SCENARIOS)
def test_scenario_against_reference(name, tmp_path, monkeypatch):
    # the port's own smoke seeds
    eng = ChaosEngine(str(tmp_path / "port"), device="cpu")
    port = [eng.run(name, seed=s, n_faults=FAULTS) for s in (0, 1)]
    for rep in port:
        assert rep.passed, [f.to_dict() for f in rep.failures]
        assert rep.record.error is None
        assert rep.record.report["unfired"] == []
        assert not any(e.get("event") == "mesh_skipped"
                       for e in rep.record.events)

    # the reference's run of the same schedule fires the same faults
    ref_eng = RefChaosEngine(str(tmp_path / "ref"))
    ref = ref_eng.run(name, seed=0, n_faults=FAULTS)
    assert ref.passed
    assert port[0].schedule.to_dict() == ref.schedule.to_dict()
    assert port[0].record.report["fired"] == ref.record.report["fired"]
    sched_sites = {f.site for f in ref.schedule.faults}
    for site in sched_sites:
        assert (port[0].record.report["counts"].get(site)
                == ref.record.report["counts"].get(site)), site

    # golden outcomes on the reference's params and batch schedules
    arrays = _ref_params()
    monkeypatch.setattr(
        MF, "init_params",
        lambda self, generator, device=None: params_from_numpy(
            self, arrays, device))
    monkeypatch.setattr(T, "epoch_permutation", _fit_perm)
    on_ref = ChaosEngine(str(tmp_path / "port-ref-params"), device="cpu")
    _same_outcome(on_ref.golden(name), ref_eng.golden(name), name)
