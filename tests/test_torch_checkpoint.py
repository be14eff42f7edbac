"""The port's checkpoints (``fia_tpu_torch.train.checkpoint``) against
the reference's (``fia_tpu.train.checkpoint``): each package's npz
loads in the other bit for bit (params, Adam state, step), the
structure strings are the reference's ``str(tree_structure(...))``, a
mismatched structure, shape or dtype raises, and the rotated directory
falls back past a damaged generation, quarantining it. Also the copied
artifact and journal layers' round trips."""

import json
import os

import jax
import numpy as np
import optax
import pytest
import torch

from fia_tpu.models import MF as RefMF
from fia_tpu.models import NCF as RefNCF
from fia_tpu.reliability import artifacts as ref_artifacts
from fia_tpu.reliability import journal as ref_journal
from fia_tpu.train import checkpoint as ref_ckpt
from fia_tpu_torch.models import MF, NCF, params_from_numpy
from fia_tpu_torch.reliability import artifacts, inject, journal
from fia_tpu_torch.train import checkpoint as ckpt
from fia_tpu_torch.train import trainer as T

torch.set_num_threads(2)

FAMILIES = {"mf": (MF, RefMF), "ncf": (NCF, RefNCF)}


@pytest.fixture(params=sorted(FAMILIES))
def pair(request):
    """The same trained-looking state on both sides: the reference's
    params, and an Adam state after three random steps."""
    Port, Ref = FAMILIES[request.param]
    ref_model, model = Ref(9, 7, 4, 1e-3), Port(9, 7, 4, 1e-3)
    r_params = ref_model.init_params(jax.random.PRNGKey(1))
    opt = optax.adam(1e-2)
    r_opt = opt.init(r_params)
    rng = np.random.default_rng(0)
    for _ in range(3):
        g = jax.tree_util.tree_map(
            lambda p: rng.standard_normal(p.shape).astype(np.float32), r_params)
        upd, r_opt = opt.update(g, r_opt, r_params)
        r_params = optax.apply_updates(r_params, upd)
    arrays = jax.tree_util.tree_map(np.asarray, r_params)
    adam = r_opt[0]
    p_opt = T.AdamState(
        torch.tensor(np.asarray(adam.count)),
        {k: torch.tensor(np.asarray(v)) for k, v in adam.mu.items()},
        {k: torch.tensor(np.asarray(v)) for k, v in adam.nu.items()})
    return (model, params_from_numpy(model, arrays, "cpu"), p_opt,
            ref_model, r_params, r_opt)


def _same_port(a: dict, b) -> None:
    assert sorted(a) == sorted(b)
    for k in a:
        want = np.asarray(b[k])
        got = a[k].numpy()
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), k


def test_structure_strings_are_the_references(pair):
    _, params, opt, _, r_params, r_opt = pair
    assert ckpt.treedef(params) == str(jax.tree_util.tree_structure(r_params))
    assert ckpt.treedef(opt) == str(jax.tree_util.tree_structure(r_opt))
    want = jax.tree_util.tree_leaves(r_opt)
    got = ckpt.leaves(opt)
    assert [np.asarray(w).tobytes() for w in want] == [
        g.numpy().tobytes() for g in got]


def test_reference_checkpoint_loads_in_the_port(pair, tmp_path):
    model, params, opt, _, r_params, r_opt = pair
    path = ref_ckpt.save(str(tmp_path / "ref"), r_params, r_opt, step=123,
                         fingerprint={"seed": 3})
    zero = {k: torch.zeros_like(v) for k, v in params.items()}
    p, o, step = ckpt.load(path, zero, T.adam_init(zero),
                           fingerprint={"seed": 3}, require_manifest=True)
    assert step == 123
    _same_port(p, r_params)
    assert o.count.dtype == torch.int32 and int(o.count) == 3
    _same_port(o.mu, r_opt[0].mu)
    _same_port(o.nu, r_opt[0].nu)


def test_port_checkpoint_loads_in_the_reference(pair, tmp_path):
    _, params, opt, ref_model, r_params, r_opt = pair
    path = ckpt.save(str(tmp_path / "port"), params, opt, step=77,
                     fingerprint={"seed": 3})
    tmpl = ref_model.init_params(jax.random.PRNGKey(9))
    p, o, step = ref_ckpt.load(path, tmpl, optax.adam(1e-2).init(tmpl),
                               fingerprint={"seed": 3}, require_manifest=True)
    assert step == 77
    for a, b in zip(jax.tree_util.tree_leaves((p, o)),
                    jax.tree_util.tree_leaves((r_params, r_opt))):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    # the npz itself: same keys, same arrays as the reference writes
    ref_path = ref_ckpt.save(str(tmp_path / "ref"), r_params, r_opt, step=77)
    with np.load(path) as a, np.load(ref_path) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].dtype == b[key].dtype, key
            assert a[key].tobytes() == b[key].tobytes(), key


def test_params_only_checkpoint(pair, tmp_path):
    _, params, opt, _, r_params, _ = pair
    path = ckpt.save(str(tmp_path / "p"), params)
    p, o, step = ckpt.load(path, params, opt)
    assert o is None and step == 0
    _same_port(p, r_params)
    assert ckpt.exists(str(tmp_path / "p")) and not ckpt.exists(str(tmp_path / "q"))


def test_mismatch_raises(pair, tmp_path):
    model, params, opt, _, _, _ = pair
    path = ckpt.save(str(tmp_path / "c"), params, opt, step=1)
    other = type(model)(9, 7, 6, 1e-3).init_params(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="shape"):
        ckpt.load(path, other)
    wrong_dtype = dict(params)
    key = sorted(params)[0]
    wrong_dtype[key] = params[key].double()
    with pytest.raises(ValueError, match="dtype"):
        ckpt.load(path, wrong_dtype)
    fewer = {k: v for k, v in params.items() if k != key}
    with pytest.raises(ValueError, match="structure"):
        ckpt.load(path, fewer)
    with pytest.raises(ValueError, match="opt structure"):
        ckpt.load(path, params, T.adam_init(fewer))
    with pytest.raises(artifacts.ArtifactIntegrityError, match="fingerprint"):
        ckpt.load(path, params, fingerprint={"seed": 1})


def test_rotation_and_fallback_past_a_damaged_generation(pair, tmp_path):
    _, params, opt, _, _, _ = pair
    d = str(tmp_path / "ckpts")
    bumped = {k: v + 1 for k, v in params.items()}
    ckpt.save_rotated(d, params, opt, step=10, keep=2)
    ckpt.save_rotated(d, bumped, opt, step=20, keep=2)
    with inject.active(inject.Fault("checkpoint.publish", at=0,
                                    kind="bitflip"), strict=True):
        ckpt.save_rotated(d, params, opt, step=30, keep=2)
    assert [s for s, _ in ckpt.generations(d)] == [20, 30]  # 10 pruned
    p, o, step = ckpt.restore_latest_valid(d, params, opt, verbose=False)
    assert step == 20
    for k in params:
        assert torch.equal(p[k], bumped[k])
    assert int(o.count) == int(opt.count)
    names = sorted(os.listdir(d))
    assert "ckpt-00000030.npz.corrupt" in names
    assert [s for s, _ in ckpt.generations(d)] == [20]
    # another config's generation is skipped and left in place
    ckpt.save_rotated(d, params, opt, step=40, keep=5, fingerprint={"a": 1})
    assert ckpt.restore_latest_valid(d, params, opt, fingerprint={"a": 2},
                                     verbose=False) is None
    assert os.path.exists(os.path.join(d, "ckpt-00000040.npz"))
    _, _, step = ckpt.restore_latest_valid(d, params, opt, fingerprint={"a": 1},
                                           verbose=False)
    assert step == 40
    assert ckpt.restore_latest_valid(str(tmp_path / "none"), params) is None


def test_periodic_checkpoints_resume_a_killed_fit(tmp_path):
    """A fit publishing every 8 steps (an epoch), killed after its last
    generation, resumes from it to the same bits as an unbroken run."""
    from fia_tpu_torch.data.synthetic import synthetic_splits

    tr = synthetic_splits(20, 15, 400, 10, seed=1)["train"]
    model = MF(20, 15, 4, 1e-3)
    trainer = T.Trainer(model, T.TrainConfig(50, 30, 1e-2, seed=4), device="cpu")
    s0 = trainer.init_state(model.init_params(torch.Generator().manual_seed(0)))
    whole = trainer.fit(s0, tr.x, tr.y)
    saver = ckpt.PeriodicCheckpointer(str(tmp_path / "g"), every=8, keep=2)
    trainer.fit(s0, tr.x, tr.y, num_steps=24, checkpointer=saver)
    assert [s for s, _ in ckpt.generations(str(tmp_path / "g"))] == [16, 24]
    p, o, step = ckpt.restore_latest_valid(str(tmp_path / "g"), s0.params,
                                           s0.opt_state, verbose=False)
    done = trainer.fit(T.TrainState(p, o, step), tr.x, tr.y,
                       num_steps=30 - step)
    for k in whole.params:
        assert torch.equal(done.params[k], whole.params[k])


def test_artifacts_and_journal_interoperate(tmp_path):
    """The copied integrity layer and journal read what the reference's
    write and the other way round."""
    arrays = {"a": np.arange(6, dtype=np.float32), "s": np.asarray("tag")}
    p1 = artifacts.publish_npz(str(tmp_path / "x.npz"), arrays,
                               fingerprint={"k": np.int64(3)})
    got = ref_artifacts.load_npz(p1, expected_fingerprint={"k": 3},
                                 require_manifest=True)
    assert got["a"].tobytes() == arrays["a"].tobytes()
    p2 = ref_artifacts.publish_npz(str(tmp_path / "y.npz"), arrays)
    assert artifacts.verify(p2)["keys"] == ["a", "s"]
    with open(p2, "r+b") as f:  # one flipped bit
        f.seek(10)
        b = f.read(1)
        f.seek(10)
        f.write(bytes([b[0] ^ 1]))
    with pytest.raises(artifacts.ArtifactIntegrityError, match="checksum"):
        artifacts.load_npz(p2)
    assert os.path.exists(p2 + ".corrupt")
    payload = {"v": np.asarray([1.5, -2.25], np.float32), "n": 3}
    jp = str(tmp_path / "j.jsonl")
    with journal.Journal.open(jp, {"run": 1}) as j:
        j.record("point:1", payload)
    with ref_journal.Journal.open(jp, {"run": 1}, resume=True) as j:
        assert j.get("point:1")["v"].tobytes() == payload["v"].tobytes()
    with pytest.raises(journal.JournalMismatch):
        journal.Journal.open(jp, {"run": 2}, resume=True)
    with open(jp) as f:
        assert json.loads(f.readline())["magic"] == journal.MAGIC
