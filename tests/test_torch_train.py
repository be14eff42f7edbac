"""The port's trainer (``fia_tpu_torch.train.trainer``) against the
reference's (``fia_tpu.train.trainer``), on the same numpy data, the
reference's params carried across, and the reference's own batch
schedules handed to the port's one schedule function
(``epoch_permutation``, monkeypatched): ``jax.random.permutation(
fold_in(PRNGKey(seed), epoch), n)`` for ``Trainer.fit`` and
``permutation(split(PRNGKey(seed), n_epochs)[epoch], n)`` for each
``loo_retrain_many`` lane (trainer.py:118, 234-243, 442-447).

Bars, port against reference: final params, Adam moments and the
final loss at rtol 1e-4 / atol 2e-5. Both sides run the same float32
formula in another order (XLA fuses and may contract a multiply-add;
Adam divides by sqrt(v), so a gradient near 0 turns one rounding of it
into a visible step): measured on these inputs, 60 steps at lr 1e-2,
the params differ by at most 6.3e-6 (NCF's W3) and 1.8e-7 (MF).

Port against port (the stacked program's invariances), on the CPU:
bitwise — lane chunking, ``steps_per_dispatch``, resume, lanes with
equal seeds, a retried transient fault, and the -1 lane against ``fit``
(MF; NCF at atol 5e-7, see ``test_sentinel_lane_equals_fit``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fia_tpu.models import MF as RefMF
from fia_tpu.models import NCF as RefNCF
from fia_tpu.train import trainer as ref_trainer
from fia_tpu_torch.models import MF, NCF, params_from_numpy
from fia_tpu_torch.reliability import inject
from fia_tpu_torch.reliability import policy as rpolicy
from fia_tpu_torch.train import trainer as T

torch.set_num_threads(2)

RTOL, ATOL = 1e-4, 2e-5
FAMILIES = {"mf": (MF, RefMF), "ncf": (NCF, RefNCF)}
U, I, K = 60, 40, 8


def _fit_perm(seed, epoch, n):
    """The reference fit's epoch permutation (trainer.py:118, 243)."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), epoch)
    return torch.from_numpy(np.array(jax.random.permutation(key, n)))


def _loo_perm(n_epochs):
    """A lane's epoch permutation in the reference's
    ``loo_retrain_many`` (trainer.py:321, 445-447), which splits the
    seed's key into exactly ``n_epochs`` keys."""

    def perm(seed, epoch, n):
        keys = jax.random.split(jax.random.PRNGKey(np.uint32(seed)), n_epochs)
        return torch.from_numpy(np.array(jax.random.permutation(keys[epoch],
                                                                n)))

    return perm


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def setup(request, tiny_splits):
    Port, Ref = FAMILIES[request.param]
    ref_model = Ref(U, I, K, 1e-3)
    arrays = jax.tree_util.tree_map(
        np.asarray, ref_model.init_params(jax.random.PRNGKey(0)))
    tr = tiny_splits["train"]
    return request.param, Port(U, I, K, 1e-3), ref_model, arrays, tr.x, tr.y


def _port_params(model, arrays):
    return params_from_numpy(model, arrays, "cpu")


def _close(port_tree: dict, ref_tree, what: str):
    for k in sorted(port_tree):
        np.testing.assert_allclose(port_tree[k].numpy(), np.asarray(ref_tree[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=f"{what} {k}")


def _state_close(ps, rs):
    _close(ps.params, rs.params, "params")
    r_adam = rs.opt_state[0]
    assert int(ps.opt_state.count) == int(r_adam.count)
    _close(ps.opt_state.mu, r_adam.mu, "mu")
    _close(ps.opt_state.nu, r_adam.nu, "nu")
    assert ps.step == rs.step


def _same_tree(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("k_steps", [1, 7])
def test_adam_and_sgd_updates_match_optax(setup, k_steps):
    """The optimizer functions alone, on random gradients."""
    _, model, _, arrays, _, _ = setup
    rng = np.random.default_rng(k_steps)
    params = _port_params(model, arrays)
    opt = T.adam_init(params)
    r_params = jax.tree_util.tree_map(jnp.asarray, arrays)
    r_opt = optax.adam(1e-2).init(r_params)
    for _ in range(k_steps):
        g = {k: rng.standard_normal(np.shape(v)).astype(np.float32)
             for k, v in arrays.items()}
        params, opt = T.adam_update({k: torch.tensor(v) for k, v in g.items()},
                                    opt, params, 1e-2)
        upd, r_opt = optax.adam(1e-2).update(g, r_opt, r_params)
        r_params = optax.apply_updates(r_params, upd)
    np.testing.assert_array_equal(opt.count.numpy(), np.asarray(r_opt[0].count))
    for k in arrays:
        np.testing.assert_allclose(params[k].numpy(), r_params[k], rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    g = {k: rng.standard_normal(np.shape(v)).astype(np.float32)
         for k, v in arrays.items()}
    got = T.sgd_update({k: torch.tensor(v) for k, v in g.items()}, params, 0.1)
    upd, _ = optax.sgd(0.1).update(g, optax.sgd(0.1).init(r_params))
    want = optax.apply_updates(jax.tree_util.tree_map(
        lambda p: jnp.asarray(p.numpy()), params), upd)
    for k in arrays:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# every phase and both orders of the two switches (trainer.py:214-223)
PHASES = {
    "minibatch": dict(),
    "three phases": dict(iter_to_switch_to_batch=30, iter_to_switch_to_sgd=45),
    "sgd before batch": dict(iter_to_switch_to_batch=40,
                             iter_to_switch_to_sgd=20),
    "full batch from 0": dict(iter_to_switch_to_batch=0),
    "sgd from 0": dict(iter_to_switch_to_batch=0, iter_to_switch_to_sgd=0),
}


@pytest.mark.parametrize("phases", sorted(PHASES))
def test_fit_matches_reference(setup, monkeypatch, phases):
    _, model, ref_model, arrays, x, y = setup
    cfg = dict(batch_size=200, num_steps=60, learning_rate=1e-2, seed=5,
               **PHASES[phases])
    ref = ref_trainer.Trainer(ref_model, ref_trainer.TrainConfig(**cfg))
    rs = ref.fit(ref.init_state(arrays), x, y)
    monkeypatch.setattr(T, "epoch_permutation", _fit_perm)
    tr = T.Trainer(model, T.TrainConfig(**cfg), device="cpu")
    ps = tr.fit(tr.init_state(_port_params(model, arrays)), x, y)
    _state_close(ps, rs)
    assert tr.last_losses.shape == (60,)
    want = float(ref_model.loss(rs.params, jnp.asarray(x), jnp.asarray(y)))
    got = float(model.loss(ps.params, torch.as_tensor(x), torch.as_tensor(y)))
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_reset_optimizer_and_retrain_match_reference(setup, monkeypatch):
    """MF retrains with a fresh Adam state, NCF keeps its own
    (matrix_factorization.py:69-76); both on weights that drop row 11."""
    family, model, ref_model, arrays, x, y = setup
    cfg = dict(batch_size=250, num_steps=24, learning_rate=1e-2, seed=2)
    w = np.ones(len(x), np.float32)
    w[11] = 0.0
    reset = family == "mf"
    ref = ref_trainer.Trainer(ref_model, ref_trainer.TrainConfig(**cfg))
    rs = ref.fit(ref.init_state(arrays), x, y)
    assert int(ref.reset_optimizer(rs).opt_state[0].count) == 0
    rs = ref.retrain(rs, x, y, weights=w, num_steps=16, reset_adam=reset)
    monkeypatch.setattr(T, "epoch_permutation", _fit_perm)
    tr = T.Trainer(model, T.TrainConfig(**cfg), device="cpu")
    ps = tr.fit(tr.init_state(_port_params(model, arrays)), x, y)
    fresh = tr.reset_optimizer(ps)
    assert int(fresh.opt_state.count) == 0 and fresh.params is ps.params
    assert all(not v.any() for v in fresh.opt_state.mu.values())
    ps = tr.retrain(ps, x, y, weights=w, num_steps=16, reset_adam=reset)
    _state_close(ps, rs)
    assert int(ps.opt_state.count) == (16 if reset else 40)


LOO_STEPS, LOO_BATCH = 25, 200  # 10 batches an epoch: 3 epochs, one partial


def test_loo_retrain_many_matches_reference(setup, monkeypatch):
    _, model, ref_model, arrays, x, y = setup
    removed, seeds = np.array([3, -1, 17, 3]), np.array([1, 2, 1, 2])
    ref = ref_trainer.loo_retrain_many(ref_model, arrays, x, y, removed,
                                       LOO_STEPS, LOO_BATCH, 1e-2, seeds=seeds,
                                       steps_per_dispatch=20)
    n_epochs = -(-LOO_STEPS // (len(x) // LOO_BATCH))
    monkeypatch.setattr(T, "epoch_permutation", _loo_perm(n_epochs))
    got = T.loo_retrain_many(model, _port_params(model, arrays), x, y, removed,
                             LOO_STEPS, LOO_BATCH, 1e-2, seeds=seeds,
                             steps_per_dispatch=20, device="cpu")
    for k in arrays:
        assert got[k].shape == (4, *np.shape(arrays[k]))
    _close(got, ref, "lanes")


def _loo(model, arrays, x, y, removed, seeds, **kw):
    return T.loo_retrain_many(model, _port_params(model, arrays), x, y,
                              np.asarray(removed), LOO_STEPS, LOO_BATCH, 1e-2,
                              seeds=np.asarray(seeds), device="cpu", **kw)


def test_sentinel_lane_equals_fit(setup):
    """A -1 lane removes nothing: it is ``fit`` with the lane's seed and
    a fresh Adam state — bit for bit for MF. NCF's stacked lanes go
    through a batched matrix product where ``fit`` takes a plain one, and
    the two round their float32 sums differently in the last bits
    (measured after 25 steps: 1.2e-7 at most), so NCF's bar is atol
    5e-7, a few float32 ulps at |w| <= 1."""
    family, model, _, arrays, x, y = setup
    lanes = _loo(model, arrays, x, y, [5, -1], [3, 3])
    tr = T.Trainer(model, T.TrainConfig(LOO_BATCH, LOO_STEPS, 1e-2, seed=3),
                   device="cpu")
    ps = tr.fit(tr.init_state(_port_params(model, arrays)), x, y)
    lane = {k: v[1] for k, v in lanes.items()}
    if family == "mf":
        _same_tree(lane, ps.params)
    for k in lane:
        np.testing.assert_allclose(lane[k].numpy(), ps.params[k].numpy(),
                                   rtol=0, atol=5e-7, err_msg=k)
    assert not all(torch.equal(lanes[k][0], lanes[k][1]) for k in lanes)


def test_equal_seed_lanes_are_equal_and_seeds_matter(setup):
    _, model, _, arrays, x, y = setup
    lanes = _loo(model, arrays, x, y, [9, 9, 9], [4, 4, 8])
    _same_tree({k: v[0] for k, v in lanes.items()},
               {k: v[1] for k, v in lanes.items()})
    assert not torch.equal(lanes["P" if "P" in lanes else "P_mlp"][0],
                           lanes["P" if "P" in lanes else "P_mlp"][2])


def test_lane_chunking_and_dispatch_split_do_not_change_lanes(setup):
    _, model, _, arrays, x, y = setup
    removed, seeds = [3, -1, 17, 3], [1, 2, 1, 2]
    whole = _loo(model, arrays, x, y, removed, seeds, steps_per_dispatch=2000)
    split = _loo(model, arrays, x, y, removed, seeds, steps_per_dispatch=1)
    _same_tree(whole, split)
    for c in (0, 2):
        part = _loo(model, arrays, x, y, removed[c:c + 2], seeds[c:c + 2])
        _same_tree({k: v[c:c + 2] for k, v in whole.items()}, part)


def test_resumed_fit_equals_unbroken(setup):
    """Stopping mid-epoch and resuming from the state replays exactly
    the batches of an unbroken run, through every phase."""
    _, model, _, arrays, x, y = setup
    cfg = T.TrainConfig(200, 40, 1e-2, seed=7, iter_to_switch_to_batch=28,
                        iter_to_switch_to_sgd=34)
    tr = T.Trainer(model, cfg, device="cpu")
    s0 = tr.init_state(_port_params(model, arrays))
    whole = tr.fit(s0, x, y)
    losses = tr.last_losses
    part = tr.fit(s0, x, y, num_steps=13)
    head = tr.last_losses
    # the resumed call sees the same phase switches at the same
    # absolute steps when it is given the remaining budget
    rest = T.Trainer(model, T.TrainConfig(200, 27, 1e-2, seed=7,
                                          iter_to_switch_to_batch=15,
                                          iter_to_switch_to_sgd=21),
                     device="cpu")
    done = rest.fit(part, x, y)
    assert done.step == whole.step == 40
    _same_tree(done.params, whole.params)
    assert torch.equal(torch.cat([head, rest.last_losses]), losses)


def test_schedule_is_a_function_of_seed_and_epoch():
    a = T.epoch_permutation(3, 1, 500)
    assert torch.equal(a, T.epoch_permutation(3, 1, 500))
    assert torch.equal(torch.sort(a).values, torch.arange(500))
    assert not torch.equal(a, T.epoch_permutation(3, 2, 500))
    assert not torch.equal(a, T.epoch_permutation(4, 1, 500))


def test_masked_row_has_no_effect(setup):
    """With w[j] = 0, row j's label changes nothing (trainer.py's
    weight vector; reference tests/test_trainer.py:39-59)."""
    _, model, _, arrays, x, y = setup
    tr = T.Trainer(model, T.TrainConfig(100, 20, 1e-2), device="cpu")
    w = np.ones(len(x), np.float32)
    w[7] = 0.0
    y2 = y.copy()
    y2[7] = 1.0 if y[7] > 3 else 5.0
    a = tr.fit(tr.init_state(_port_params(model, arrays)), x, y, weights=w)
    b = tr.fit(tr.init_state(_port_params(model, arrays)), x, y2, weights=w)
    _same_tree(a.params, b.params)


def test_transient_faults_retry_to_the_same_result(setup):
    """An injected worker fault at a dispatch is retried (in virtual
    time) and replays its segment exactly; an unclassified one rises."""
    _, model, _, arrays, x, y = setup
    clock = rpolicy.VirtualClock()
    tr = T.Trainer(model, T.TrainConfig(200, 25, 1e-2), device="cpu",
                   clock=clock)
    s0 = tr.init_state(_port_params(model, arrays))
    clean = tr.fit(s0, x, y)
    with inject.active(inject.Fault("trainer.epoch", at=1, kind="worker"),
                       strict=True) as inj:
        again = tr.fit(s0, x, y)
    assert inj.log == [("trainer.epoch", 1, "worker")] and clock.monotonic() > 0
    _same_tree(clean.params, again.params)
    with inject.active(inject.Fault("trainer.loo_segment", at=0,
                                    kind="preemption"), strict=True):
        lanes = _loo(model, arrays, x, y, [3, -1], [1, 1],
                     clock=rpolicy.VirtualClock())
    _same_tree(lanes, _loo(model, arrays, x, y, [3, -1], [1, 1]))
    with inject.active(inject.Fault("trainer.epoch", at=0, kind="oom")):
        with pytest.raises(RuntimeError, match="RESOURCE_EXHAUSTED"):
            tr.fit(s0, x, y)


def test_errors_and_default_device(setup, monkeypatch):
    _, model, _, arrays, x, y = setup
    with pytest.raises(ValueError, match="batch_size"):
        T.Trainer(model, T.TrainConfig(len(x) + 1, 2), device="cpu").fit(
            T.Trainer(model, T.TrainConfig(1, 1), device="cpu").init_state(
                _port_params(model, arrays)), x, y)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.Trainer(model, T.TrainConfig(10, 2))
    with pytest.raises(RuntimeError, match="CUDA"):
        T.loo_retrain_many(model, arrays, x, y, [1], 2, 10)


@pytest.mark.parametrize("fn", ["Trainer.__init__", "loo_retrain_many"])
def test_signature_is_the_references(fn):
    """The reference's parameters, in its order and with its defaults
    (``mesh`` among them); the port's own ``device`` comes last."""
    import inspect

    def resolve(mod):
        obj = mod
        for part in fn.split("."):
            obj = getattr(obj, part)
        return inspect.signature(obj).parameters

    port, ref = resolve(T), resolve(ref_trainer)
    assert list(port)[-1] == "device"
    assert [p for p in port if p != "device"] == list(ref)
    for name, p in ref.items():
        if p.default is not inspect.Parameter.empty:
            assert port[name].default == p.default, name


def test_unported_options_raise(setup):
    """A mesh (data parallelism, lane sharding) is ported: over 2 virtual
    slots ``fit`` meets the reference's mesh bar (rtol 2e-4 / atol 1e-5)
    of ``mesh=None``, and ``loo_retrain_many`` returns its one lane (the
    padding lane sliced away) at the same bar."""
    from fia_tpu_torch.parallel import mesh as pmesh

    _, model, _, arrays, x, y = setup
    cfg = T.TrainConfig(200, 5, 1e-2)
    tr = T.Trainer(model, cfg, mesh=None, device="cpu")
    want = tr.fit(tr.init_state(_port_params(model, arrays)), x, y)
    lanes = T.loo_retrain_many(model, _port_params(model, arrays), x, y,
                               [3], 2, 200, mesh=None, device="cpu")
    assert all(v.shape[0] == 1 for v in lanes.values())
    with pmesh.virtual_devices(2):
        m = pmesh.make_mesh(2, device="cpu")
        tm = T.Trainer(model, cfg, mesh=m, device="cpu")
        got = tm.fit(tm.init_state(_port_params(model, arrays)), x, y)
        mlanes = T.loo_retrain_many(model, _port_params(model, arrays), x,
                                    y, [3], 2, 200, mesh=m, device="cpu")
    for k in want.params:
        np.testing.assert_allclose(got.params[k].numpy(),
                                   want.params[k].numpy(), rtol=2e-4,
                                   atol=1e-5)
        assert mlanes[k].shape == lanes[k].shape
        np.testing.assert_allclose(mlanes[k].numpy(), lanes[k].numpy(),
                                   rtol=2e-4, atol=1e-5)


def test_reliability_copies_match_reference():
    """The copied classifier, backoff schedule and deadline behave as
    the reference's (the retry and deadline paths above rely on them)."""
    from fia_tpu.reliability import inject as ref_inject
    from fia_tpu.reliability import policy as ref_policy
    from fia_tpu.reliability import taxonomy as ref_tax
    from fia_tpu_torch.reliability import taxonomy

    assert inject.MESSAGES == ref_inject.MESSAGES
    errors = [RuntimeError(m) for m in inject.MESSAGES.values()] + [
        MemoryError("x"), taxonomy.DeadlineExpired("d"), ValueError("other"),
        RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB"),
        RuntimeError("TPU backend error (compile)")]
    for e in errors:
        ref_e = (ref_tax.DeadlineExpired("d")
                 if isinstance(e, taxonomy.DeadlineExpired) else e)
        assert taxonomy.classify(e) == ref_tax.classify(ref_e), e
    assert taxonomy.TRANSIENT == ref_tax.TRANSIENT
    for seed in (0, 7):
        a = rpolicy.RetryPolicy(max_attempts=5, seed=seed)
        b = ref_policy.RetryPolicy(max_attempts=5, seed=seed)
        assert a.delays() == b.delays()
    clock = rpolicy.VirtualClock()
    d = rpolicy.Deadline(2.0, clock=clock)
    d.check()
    clock.sleep(2.5)
    assert d.expired() and rpolicy.Deadline(None, clock=clock).remaining() > 1e9
    with pytest.raises(taxonomy.DeadlineExpired):
        d.check("test")
