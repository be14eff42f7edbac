"""The port's ``FIAModel`` facade (``fia_tpu_torch/api.py``) on the CPU.

Restates ``tests/test_api.py`` port against port on ``tiny_splits``
(MF, k = 4): training and the checkpoint round trip, influence and
related rows, the test block, retraining, the Hessian's extreme
eigenvalues, the gradient of influence, a resumed run keeping the phase
schedule, the dataset updaters, and the spectral tools. Nothing of that
file needs ``serve`` or ``stream``, so none of it is left out; ``serve``
with a host role journals its shard and answers the facade's influence
(``serve`` itself is held in ``test_torch_serve.py``, host roles in
``test_torch_multihost.py``), and ``apply_updates`` / ``apply_removal``
commit here, with the reference's signatures (the write path itself is
held in ``test_torch_stream.py`` and ``test_torch_audit.py``). Added: the
facade's
influence is bitwise the engine's; the iHVP disk cache serves, and
misses after a params change; the factor bank is refreshed by a params
change. The eigenvalues are held to a float64 eigendecomposition of the
materialised full Hessian, and the facade's iHVP to the full engine's.
Over a 2-slot mesh of virtual CPU slots (``TestMesh``) the facade trains
data parallel within the reference's training bar (rtol 2e-4 / atol
1e-5) of the meshless facade, its influence is the meshless engine's on
the same params bit for bit, and ``serve(config=ServeConfig(mesh=2))``
builds its engine over a mesh of that fingerprint.
"""

import os

import numpy as np
import pytest
import torch

from fia_tpu_torch.api import FIAModel
from fia_tpu_torch.data.dataset import RatingDataset
from fia_tpu_torch.influence import factor as fbank
from fia_tpu_torch.influence import hvp as HV
from fia_tpu_torch.influence.engine import InfluenceEngine
from fia_tpu_torch.parallel import mesh as pmesh
from fia_tpu_torch.serve import Request, ServeConfig
from fia_tpu_torch.influence.spectral import (block_hessian_eigvals,
                                              extreme_eigvals)

torch.set_num_threads(2)


def _port_splits(tiny_splits):
    return {k: RatingDataset(v.x, v.y) for k, v in tiny_splits.items()
            if v is not None}


def _model(splits, train_dir, name="t", **kw):
    return FIAModel(model="MF", num_users=60, num_items=40, embedding_size=4,
                    weight_decay=1e-3, batch_size=200, data_sets=splits,
                    initial_learning_rate=1e-2, train_dir=str(train_dir),
                    model_name=name, device="cpu", **kw)


@pytest.fixture(scope="module")
def fia(tiny_splits, tmp_path_factory):
    m = _model(_port_splits(tiny_splits), tmp_path_factory.mktemp("out"),
               damping=1e-4)
    m.train(num_steps=600, verbose=False)
    return m


class TestFacade:
    def test_train_and_checkpoint_roundtrip(self, fia):
        p_before = fia.params["P"].clone()
        fia.load_checkpoint(599, do_checks=False)
        np.testing.assert_allclose(fia.params["P"], p_before)

    def test_influence_and_related(self, fia):
        scores = fia.get_influence_on_test_loss([0])
        rel = fia.get_train_indices_of_test_case([0])
        assert scores.shape == rel.shape
        assert np.isfinite(scores).all()

    def test_influence_is_the_engines_bitwise(self, fia):
        pt = fia.data_sets["test"].x[3][None].astype(np.int64)
        eng = InfluenceEngine(fia.model, fia.params, fia.data_sets["train"],
                              damping=fia.damping, device="cpu")
        got = fia.get_influence_on_test_loss([3])
        assert got.tobytes() == eng.query_batch(pt).scores_of(0).tobytes()

    def test_test_params_block(self, fia):
        assert set(fia.get_test_params([0])) == {"pu", "qi", "bu", "bi"}

    def test_retrain_changes_params(self, fia):
        p_before = fia.params["P"].clone()
        fia.retrain(num_steps=20)
        assert not np.allclose(fia.params["P"], p_before)
        fia.load_checkpoint(599, do_checks=False)

    def test_eigvals(self, fia):
        lam_max, lam_min = fia.find_eigvals_of_hessian(num_iters=50)
        assert np.isfinite(lam_max) and np.isfinite(lam_min)
        assert lam_max >= lam_min
        tr = fia.data_sets["train"]
        H = HV.materialize_full_hessian(fia.model, fia.params,
                                        torch.as_tensor(tr.x),
                                        torch.as_tensor(tr.y))
        w = np.linalg.eigvalsh(H.double().numpy())
        np.testing.assert_allclose(lam_max, w[-1], rtol=1e-2)

    def test_inverse_hvp_is_the_full_engines(self, fia):
        from fia_tpu_torch.influence.full import FullInfluenceEngine

        full = FullInfluenceEngine(fia.model, fia.params,
                                   fia.data_sets["train"], damping=1e-2,
                                   solver="cg", device="cpu")
        v = full.test_loss_grad(fia.data_sets["test"].x[:2],
                                fia.data_sets["test"].y[:2])
        fia.damping, damping = 1e-2, fia.damping
        try:
            got = fia.get_inverse_hvp(v)
        finally:
            fia.damping = damping
        assert torch.equal(got, full.get_inverse_hvp(v))

    def test_grad_of_influence_wrt_input(self, fia):
        rel = fia.get_train_indices_of_test_case([0])
        out = fia.get_grad_of_influence_wrt_input([0], rel[:2])
        assert len(out) == 2
        for g in out:
            assert set(g) == {"pu", "qi", "bu", "bi"}
            assert all(torch.isfinite(v).all() for v in g.values())

    def test_resume_preserves_phase_schedule(self, tiny_splits, tmp_path):
        kw = dict(iter_to_switch_to_batch=25, iter_to_switch_to_sgd=32)
        a = _model(_port_splits(tiny_splits), tmp_path, "fresh")
        a.train(num_steps=40, verbose=False, **kw)
        b = _model(_port_splits(tiny_splits), tmp_path, "resumed")
        b.train(num_steps=17, verbose=False)
        b.train(num_steps=40, verbose=False, load_checkpoints=16, **kw)
        for k in a.params:
            np.testing.assert_allclose(a.params[k], b.params[k], rtol=1e-5,
                                       atol=1e-6)

    def test_update_datasets(self, fia, tiny_splits):
        n = fia.num_train_examples
        tr = tiny_splits["train"]
        fia.update_train_x_y(tr.x[: n - 5], tr.y[: n - 5])
        assert fia.num_train_examples == n - 5
        fia.update_train_x_y(tr.x, tr.y)
        fia.update_train_x(tr.x)
        assert fia.num_train_examples == n
        fia.reset_datasets()

    def test_print_model_eval(self, fia, capsys):
        fia.print_model_eval()
        out = capsys.readouterr().out
        assert "Train loss (w reg) on all data:" in out
        assert "Norm of the mean of gradients:" in out

    @pytest.mark.parametrize("call,item", [
        (lambda m, d, h: m.serve(config=ServeConfig(
            host_role=(h, 1, d), disk_cache=False)), "A.13"),
    ])
    def test_unported_surfaces_raise(self, fia, call, item, tmp_path):
        """The surface ROADMAP Queue A.13b ported last: ``serve`` with a
        host role journals its shard and answers bitwise the facade's own
        influence, and a host index outside the host count raises, as
        the reference's (a mesh: ``TestMesh``)."""
        with pytest.raises(ValueError, match="out of range"):
            call(fia, str(tmp_path), 1)
        svc = call(fia, str(tmp_path), 0)
        assert svc.host_role == (0, 1, str(tmp_path)), item
        pts = fia.data_sets["test"].x[:5].astype(np.int64)
        got = svc.run([Request(int(u), int(i)) for u, i in pts])
        assert os.listdir(tmp_path)
        want = fia.engine().query_batch(pts)
        for t, r in enumerate(got):
            assert r.ok
            assert np.asarray(r.scores).tobytes() == \
                np.asarray(want.scores_of(t)).tobytes()

    @pytest.mark.parametrize("call,rows", [
        (lambda m: m.apply_updates(np.array([[1, 2], [3, 4]], np.int64),
                                   np.array([5.0, 1.0], np.float32),
                                   steps=4), +2),
        (lambda m: m.apply_removal([0, 7], steps=4), -2),
    ], ids=["apply_updates", "apply_removal"])
    def test_write_path_commits(self, tiny_splits, tmp_path, call, rows):
        m = _model(_port_splits(tiny_splits), tmp_path, damping=1e-3)
        m.train(num_steps=20, verbose=False, save_checkpoints=False)
        n, step = m.num_train_examples, int(m.state.step)
        r = call(m)
        assert r.committed, (r.status, r.reason)
        assert m.num_train_examples == n + rows
        assert int(m.state.step) == step + 4

    @pytest.mark.parametrize("name", ["apply_updates", "apply_removal"])
    def test_write_path_signature_is_the_references(self, name):
        import inspect

        from fia_tpu.api import FIAModel as RefFIAModel

        port = inspect.signature(getattr(FIAModel, name)).parameters
        ref = inspect.signature(getattr(RefFIAModel, name)).parameters
        assert list(port) == list(ref)
        for key, p in ref.items():
            assert port[key].default == p.default, key


class TestMesh:
    @pytest.fixture(autouse=True)
    def slots(self):
        with pmesh.virtual_devices(2):
            yield

    def test_mesh_facade_trains_and_queries(self, tiny_splits, tmp_path):
        m = pmesh.make_mesh(2, device="cpu")
        a = _model(_port_splits(tiny_splits), tmp_path / "a", damping=1e-3)
        b = _model(_port_splits(tiny_splits), tmp_path / "b", damping=1e-3,
                   mesh=m)
        assert b._trainer.mesh is m and b.device == torch.device("cpu")
        for f in (a, b):
            f.train(num_steps=40, verbose=False, save_checkpoints=False)
        for k in a.params:
            np.testing.assert_allclose(b.params[k], a.params[k], rtol=2e-4,
                                       atol=1e-5)
        eng = b.engine()
        assert eng.mesh is m
        single = InfluenceEngine(b.model, b.params, b.data_sets["train"],
                                 damping=b.damping, device="cpu")
        pt = b.data_sets["test"].x[3][None].astype(np.int64)
        assert b.get_influence_on_test_loss([3]).tobytes() == \
            single.query_batch(pt).scores_of(0).tobytes()
        # an explicit mesh in extra builds another engine beside it
        other = b.engine(mesh=None)
        assert other is not eng and other.mesh is None

    def test_serve_config_mesh_builds_mesh_engines(self, tiny_splits,
                                                   tmp_path):
        f = _model(_port_splits(tiny_splits), tmp_path, damping=1e-3)
        f.train(num_steps=20, verbose=False, save_checkpoints=False)
        svc = f.serve(config=ServeConfig(mesh=2, disk_cache=False))
        eng = svc._peek_engine()
        assert pmesh.mesh_fingerprint(eng.mesh) == pmesh.mesh_fingerprint(
            pmesh.make_mesh(2, device="cpu"))
        pts = np.asarray(f.data_sets["test"].x[:4], np.int64)
        want = f.engine(mesh=None).query_batch(pts)
        from fia_tpu_torch.serve import Request

        got = svc.run([Request(int(u), int(i), id=str(k))
                       for k, (u, i) in enumerate(pts)])
        for k, r in enumerate(got):
            assert r.ok and np.array_equal(r.scores, want.scores_of(k))


class TestCachesAndBank:
    def test_ihvp_cache_serves_and_misses_after_change(self, tiny_splits,
                                                       tmp_path):
        m = _model(_port_splits(tiny_splits), tmp_path, damping=1e-3)
        m.train(num_steps=30, verbose=False, save_checkpoints=False)
        first = m.get_influence_on_test_loss([1])
        eng = m.engine()
        path = os.path.join(str(tmp_path), "t-direct-normal_loss-test-[1].npz")
        assert os.path.exists(path)
        calls = []
        real = eng.query_batch
        eng.query_batch = lambda *a, **k: calls.append(1) or real(*a, **k)
        hit = m.get_influence_on_test_loss([1], force_refresh=False)
        assert hit.tobytes() == first.tobytes() and not calls
        m.retrain(num_steps=5)  # new params: the fingerprint misses
        again = m.get_influence_on_test_loss([1], force_refresh=False)
        assert not np.array_equal(again, first)

    def test_params_change_refreshes_the_bank(self, tiny_splits, tmp_path,
                                              capsys):
        m = _model(_port_splits(tiny_splits), tmp_path, damping=1e-3)
        m.train(num_steps=30, verbose=False, save_checkpoints=False)
        eng = m.engine(solver="direct")
        pairs = fbank.select_hot_pairs(eng.index, 16, 4, 4)
        bank = fbank.build_bank(eng, pairs, batch_queries=16)
        fbank.publish_bank(bank, eng.factor_bank_path(),
                           fbank.bank_fingerprint("t", 10, 1e-3,
                                                  *eng._train_host))
        assert m.engine(solver="precomputed").ensure_factor_bank() == 16
        m.retrain(num_steps=3)  # every row moves: every entry is touched
        assert "[factor.refresh] kept=0 dropped=16" in capsys.readouterr().err
        assert m.engine(solver="precomputed").ensure_factor_bank() == 0


class TestSpectral:
    def test_power_iteration_matches_eigh(self):
        rng = np.random.default_rng(0)
        A = rng.normal(size=(12, 12))
        H = torch.as_tensor(A @ A.T, dtype=torch.float32)
        lam_max, lam_min = extreme_eigvals(lambda v: H @ v, 12, num_iters=500)
        w = np.linalg.eigvalsh(H.double().numpy())
        np.testing.assert_allclose(float(lam_max), w[-1], rtol=1e-3)
        np.testing.assert_allclose(float(lam_min), w[0], atol=1e-2 * w[-1])

    def test_indefinite_negative_dominant(self):
        H = torch.diag(torch.tensor([-10.0, -2.0, 1.0, 3.0]))
        lam_max, lam_min = extreme_eigvals(lambda v: H @ v, 4, num_iters=500)
        np.testing.assert_allclose(float(lam_max), 3.0, rtol=1e-3)
        np.testing.assert_allclose(float(lam_min), -10.0, rtol=1e-3)

    def test_block_eigvals(self):
        H = torch.diag(torch.tensor([1.0, 2.0, 3.0]))
        np.testing.assert_allclose(block_hessian_eigvals(H), [1.0, 2.0, 3.0])
