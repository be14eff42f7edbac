"""The port's sharded checkpoints (``fia_tpu_torch/train/checkpoint_orbax.py``,
on ``torch.distributed.checkpoint``) on the CPU, with no process group.

Restates ``tests/test_aux.py::TestOrbaxCheckpoint`` (both: a round trip,
and the asymmetric restore that still rejects a mismatched template) port
against port, then the rest of the contract the reference's module keeps:
an optimizer state saved and restored bitwise, a checkpoint saved without
one restoring with an optimizer template, and tree, shape and dtype
mismatches raising ``ValueError``. Row-sharded params
(``shard_model_params`` on a ``(2, 2)`` mesh of virtual CPU slots) round
trip bit for bit, each shard on its slot's device and shared by the slots
that held one tensor, a ``(1, 4)`` template rejects them, and the
influence of an engine built from the restored tables is the saved
engine's, bit for bit. The same save and restore across two processes
over gloo is held in ``test_torch_distributed.py``.
"""

import numpy as np
import pytest
import torch

from fia_tpu_torch.data.dataset import RatingDataset
from fia_tpu_torch.influence.engine import InfluenceEngine
from fia_tpu_torch.models import MF, NCF
from fia_tpu_torch.parallel import mesh as pmesh
from fia_tpu_torch.parallel.sharded import (
    Placed,
    make_2d_mesh,
    shard_model_params,
    whole_params,
)
from fia_tpu_torch.train import checkpoint_orbax as co
from fia_tpu_torch.train.trainer import AdamState

torch.set_num_threads(2)

USERS, ITEMS, K = 21, 13, 4
PTS = np.array([[3, 5], [0, 1], [7, 2], [11, 9], [20, 12]], np.int64)


@pytest.fixture(autouse=True, scope="module")
def slots():
    with pmesh.virtual_devices(8):
        yield


class TestOrbaxCheckpoint:
    def test_roundtrip(self, tmp_path):
        params = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
                  "b": np.zeros(4, np.float32)}
        path = co.save(str(tmp_path / "ck"), params, step=7)
        assert co.exists(path)
        p2, o2, step = co.load(path, params)
        assert step == 7 and o2 is None
        np.testing.assert_allclose(p2["a"], params["a"])

    def test_asymmetric_restore_validates_template(self, tmp_path):
        """A checkpoint saved WITH opt_state restores when loaded without
        one — but a template whose shapes don't match must still be
        rejected, not silently ignored."""
        params = {"a": np.arange(6, dtype=np.float32).reshape(2, 3)}
        opt = {"m": np.zeros((2, 3), np.float32)}
        path = co.save(str(tmp_path / "ck"), params, opt_state=opt, step=3)

        p2, o2, step = co.load(path, params)  # no opt template
        assert step == 3 and o2 is None
        np.testing.assert_allclose(p2["a"], params["a"])

        bad = {"a": np.zeros((4, 5), np.float32)}
        with pytest.raises(ValueError):
            co.load(path, bad)


def _model_params(cls=MF, seed=0):
    model = cls(USERS, ITEMS, K, 1e-3)
    return model, model.init_params(torch.Generator().manual_seed(seed))


def _same(a, b) -> bool:
    return torch.as_tensor(a).dtype == torch.as_tensor(b).dtype and \
        np.asarray(a).tobytes() == np.asarray(b).tobytes()


class TestContract:
    @pytest.mark.parametrize("cls", [MF, NCF], ids=["mf", "ncf"])
    def test_params_and_adam_state_bitwise(self, tmp_path, cls):
        _, params = _model_params(cls)
        opt = AdamState(torch.tensor(5, dtype=torch.int32),
                        {k: v * 0.5 for k, v in params.items()},
                        {k: v * v for k, v in params.items()})
        path = co.save(str(tmp_path / "ck"), params, opt, step=11)
        got, got_opt, step = co.load(path, params, opt)
        assert step == 11 and isinstance(got_opt, AdamState)
        assert all(_same(got[k], params[k]) for k in params)
        assert _same(got_opt.count, opt.count)
        for part in ("mu", "nu"):
            assert all(_same(getattr(got_opt, part)[k],
                             getattr(opt, part)[k]) for k in params)

    def test_saved_without_opt_restores_with_template(self, tmp_path):
        _, params = _model_params()
        opt = AdamState(torch.tensor(1), dict(params), dict(params))
        path = co.save(str(tmp_path / "ck"), params, step=2)
        got, got_opt, step = co.load(path, params, opt)
        assert (got_opt, step) == (None, 2)
        assert all(_same(got[k], params[k]) for k in params)

    def test_overwrites_an_existing_checkpoint(self, tmp_path):
        _, params = _model_params()
        path = co.save(str(tmp_path / "ck"), params, step=1)
        later = {k: v + 1 for k, v in params.items()}
        co.save(path, later, step=2)
        got, _, step = co.load(path, params)
        assert step == 2 and all(_same(got[k], later[k]) for k in params)

    @pytest.mark.parametrize("change", ["shape", "dtype", "missing",
                                        "extra", "opt_shape"])
    def test_mismatched_template_raises(self, tmp_path, change):
        _, params = _model_params()
        opt = AdamState(torch.tensor(1), dict(params), dict(params))
        path = co.save(str(tmp_path / "ck"), params, opt, step=1)
        tmpl, otmpl = dict(params), opt
        if change == "shape":
            tmpl["P"] = torch.zeros(USERS + 1, K)
        elif change == "dtype":
            tmpl["P"] = params["P"].double()
        elif change == "missing":
            del tmpl["bg"]
        elif change == "extra":
            tmpl["W"] = torch.zeros(2)
        else:
            otmpl = AdamState(opt.count, {**opt.mu, "P": torch.zeros(2, 2)},
                              opt.nu)
        with pytest.raises(ValueError):
            co.load(path, tmpl, otmpl)


class TestShardedCheckpoint:
    def test_row_sharded_roundtrip_bitwise_on_slots(self, tmp_path):
        model, params = _model_params()
        mesh = make_2d_mesh(4, model_parallel=2, device="cpu")
        placed = shard_model_params(mesh, params, model)
        path = co.save(str(tmp_path / "ck"), placed, step=4)
        zeros = {k: torch.zeros_like(v) for k, v in params.items()}
        tmpl = shard_model_params(mesh, zeros, model)
        got, _, step = co.load(path, tmpl)
        assert step == 4
        for k, p in placed.items():
            g = got[k]
            assert isinstance(g, Placed) and g.axis == p.axis
            assert g.shape == p.shape
            for slot, a, b in zip(mesh.devices.flat, g.shards, p.shards):
                assert a.device == slot.device and _same(a, b)
            # slots that shared one tensor share one again
            assert len({id(x) for x in g.shards}) == len(
                {id(x) for x in p.shards})
        assert all(_same(v, params[k])
                   for k, v in whole_params(got, model).items())
        # the inverse of the placement
        assert all(_same(v, params[k])
                   for k, v in whole_params(placed, model).items())

    def test_other_model_axis_rejected(self, tmp_path):
        model, params = _model_params()
        two = shard_model_params(make_2d_mesh(4, model_parallel=2,
                                              device="cpu"), params, model)
        path = co.save(str(tmp_path / "ck"), two, step=1)
        four = shard_model_params(make_2d_mesh(4, model_parallel=4,
                                               device="cpu"), params, model)
        with pytest.raises(ValueError, match="tree"):
            co.load(path, four)
        with pytest.raises(ValueError, match="tree"):
            co.load(path, params)  # whole tables against shards

    @pytest.mark.parametrize("cls", [MF, NCF], ids=["mf", "ncf"])
    def test_restored_tables_query_bitwise(self, tmp_path, cls):
        """A sharded engine's params saved, restored into a template of
        zeros, an engine rebuilt from them: its influence is the saved
        engine's, bit for bit."""
        model, params = _model_params(cls, seed=3)
        rng = np.random.default_rng(0)
        x = np.stack([rng.integers(0, USERS, 300),
                      rng.integers(0, ITEMS, 300)], 1).astype(np.int32)
        train = RatingDataset(x, rng.integers(1, 6, 300).astype(np.float32))
        mesh = make_2d_mesh(4, model_parallel=2, device="cpu")
        eng = InfluenceEngine(model, params, train, damping=1e-3, mesh=mesh,
                              shard_tables=True, device="cpu")
        before = eng.query_batch(PTS)
        path = co.save(str(tmp_path / "ck"), eng.params, step=9)
        zeros = {k: torch.zeros_like(v) for k, v in params.items()}
        tmpl = InfluenceEngine(model, zeros, train, damping=1e-3, mesh=mesh,
                               shard_tables=True, device="cpu").params
        got, _, _ = co.load(path, tmpl)
        again = InfluenceEngine(model, whole_params(got, model), train,
                                damping=1e-3, mesh=mesh, shard_tables=True,
                                device="cpu").query_batch(PTS)
        assert before._packed.tobytes() == again._packed.tobytes()
        assert np.asarray(before.ihvp).tobytes() == \
            np.asarray(again.ihvp).tobytes()
