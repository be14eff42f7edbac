"""Parity of the port's engine with the port's torch-CPU reference engine
(``fia_tpu_torch/backends/torch_ref.py``), restating
``tests/test_parity.py`` port against port on the CPU: influence-score
rank correlation (Spearman) and Pearson >= 0.99 against the
reference-architecture implementation on briefly-trained models, and the
test vectors. The port's ``torch_ref`` is also held to the reference's
copy: the same arrays on the same inputs.
"""

import numpy as np
import pytest
import torch

from fia_tpu.backends import torch_ref as ref_torch_ref
from fia_tpu_torch.backends.torch_ref import TorchRefMFEngine, TorchRefNCFEngine
from fia_tpu_torch.data.dataset import RatingDataset
from fia_tpu_torch.eval.metrics import pearson, spearman
from fia_tpu_torch.influence.engine import InfluenceEngine
from fia_tpu_torch.influence.grads import block_prediction_grad
from fia_tpu_torch.models import MF, NCF
from fia_tpu_torch.train.trainer import Trainer, TrainConfig

torch.set_num_threads(2)

WD = 1e-3
DAMP = 1e-6


def _train(model, seed, splits, steps):
    train = splits["train"]
    params = model.init_params(torch.Generator().manual_seed(seed))
    tr = Trainer(model, TrainConfig(batch_size=200, num_steps=steps,
                                    learning_rate=1e-2), device="cpu")
    state = tr.fit(tr.init_state(params), train.x, train.y)
    return state.params, RatingDataset(train.x, train.y)


def _host(params) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


def _engine(model, params, train):
    return InfluenceEngine(model, params, train, damping=DAMP,
                           solver="direct", device="cpu")


@pytest.fixture(scope="module")
def trained_mf(tiny_splits):
    train = tiny_splits["train"]
    model = MF(train.num_users, train.num_items, 4, WD)
    params, ds = _train(model, 0, tiny_splits, 1200)
    return model, params, ds


class TestTorchParity:
    def test_scores_match_reference_impl(self, tiny_splits, trained_mf):
        model, params, train = trained_mf
        ref = TorchRefMFEngine(_host(params), train.x, train.y,
                               weight_decay=WD, damping=DAMP)
        eng = _engine(model, params, train)

        test_pts = tiny_splits["test"].x[:4]
        rhos, rs = [], []
        for u, i in test_pts:
            ref_scores, ref_rows = ref.query(int(u), int(i))
            res = eng.query_batch(np.array([[u, i]]))
            got = res.scores_of(0)
            assert np.array_equal(res.related_of(0), ref_rows)
            rhos.append(spearman(got, ref_scores))
            rs.append(pearson(got, ref_scores))
        assert min(rhos) >= 0.99, (rhos, rs)
        assert min(rs) >= 0.99, (rhos, rs)

    def test_ncf_scores_match_reference_impl(self, tiny_splits):
        """NCF parity: the 4-embedding-row block (4k params, MLP weights
        excluded) against the torch fmin_ncg reference engine, at its
        defaults and against its converged solve."""
        train = tiny_splits["train"]
        model = NCF(train.num_users, train.num_items, 4, WD)
        params, ds = _train(model, 1, tiny_splits, 800)

        host = _host(params)
        ref = TorchRefNCFEngine(host, ds.x, ds.y, weight_decay=WD,
                                damping=DAMP)
        eng = _engine(model, params, ds)
        train_pairs = set(map(tuple, ds.x.tolist()))
        pts = [tuple(p) for p in tiny_splits["test"].x
               if tuple(p) not in train_pairs][:3]
        assert pts, "test split fully collides with train pairs"
        rhos, rs = [], []
        ref_tight = TorchRefNCFEngine(host, ds.x, ds.y, weight_decay=WD,
                                      damping=DAMP, avextol=1e-10,
                                      maxiter=2000)
        rhos_tight = []
        for u, i in pts:
            ref_scores, ref_rows = ref.query(int(u), int(i))
            res = eng.query_batch(np.array([[u, i]]))
            assert np.array_equal(res.related_of(0), ref_rows)
            rhos.append(spearman(res.scores_of(0), ref_scores))
            rs.append(pearson(res.scores_of(0), ref_scores))
            rhos_tight.append(
                spearman(res.scores_of(0), ref_tight.query(int(u), int(i))[0])
            )
        assert min(rhos) >= 0.99, (rhos, rs)
        assert min(rs) >= 0.99, (rhos, rs)
        assert min(rhos_tight) >= 0.999, rhos_tight

    def test_ncf_test_vector_parity(self, tiny_splits):
        train = tiny_splits["train"]
        model = NCF(train.num_users, train.num_items, 4, WD)
        params = model.init_params(torch.Generator().manual_seed(2))
        ref = TorchRefNCFEngine(_host(params), train.x, train.y,
                                weight_decay=WD, damping=DAMP)
        u, i = 3, 5
        v = block_prediction_grad(model, params, torch.tensor(u),
                                  torch.tensor(i),
                                  torch.tensor([[u, i]], dtype=torch.int32))
        np.testing.assert_allclose(v.numpy(), ref.test_vector(u, i),
                                   rtol=1e-4, atol=1e-6)

    def test_test_vector_parity(self, trained_mf):
        model, params, train = trained_mf
        ref = TorchRefMFEngine(_host(params), train.x, train.y,
                               weight_decay=WD, damping=DAMP)
        u, i = 3, 5
        v = block_prediction_grad(model, params, torch.tensor(u),
                                  torch.tensor(i),
                                  torch.tensor([[u, i]], dtype=torch.int32))
        np.testing.assert_allclose(v.numpy(), ref.test_vector(u, i),
                                   rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("family", ["mf", "ncf"])
def test_port_torch_ref_equals_the_references(tiny_splits, family):
    """The port's copy and the reference's give equal arrays on the same
    inputs (both on the CPU, at this file's two threads): test vector,
    related rows and every score."""
    train = tiny_splits["train"]
    cls, port_cls, ref_cls = {
        "mf": (MF, TorchRefMFEngine, ref_torch_ref.TorchRefMFEngine),
        "ncf": (NCF, TorchRefNCFEngine, ref_torch_ref.TorchRefNCFEngine),
    }[family]
    model = cls(train.num_users, train.num_items, 4, WD)
    host = _host(model.init_params(torch.Generator().manual_seed(3)))
    port = port_cls(host, train.x, train.y, weight_decay=WD, damping=DAMP)
    ref = ref_cls(host, train.x, train.y, weight_decay=WD, damping=DAMP)
    for u, i in tiny_splits["test"].x[:2]:
        u, i = int(u), int(i)
        assert np.array_equal(port.test_vector(u, i), ref.test_vector(u, i))
        got, want = port.query(u, i), ref.query(u, i)
        assert np.array_equal(got[1], want[1])
        assert np.array_equal(got[0], want[0])
