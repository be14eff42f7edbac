"""The fault-injection site registry (copy of
``fia_tpu/reliability/sites.py``, the same names).

Every named injection point — the ``site=`` strings passed to
:func:`fia_tpu_torch.reliability.inject.fire` / ``inject.corrupt`` /
``inject.damage`` and to
:func:`fia_tpu_torch.reliability.artifacts.publish_npz` — is declared
here, once, as a module constant. The names are the reference's, so a
fault plan scripted against the reference (its chaos scenarios) can be
pointed at the port's entry points unchanged. Sites of subsystems the
port has not reached yet are registered all the same.

A typo'd site name would fail silently — ``inject.fire("trainer.epoh")``
is a valid no-op call, so a plan armed against the real site never
fires — so :func:`check` turns an unknown name into an error when a
plan is armed with ``validate=True``.
"""

from __future__ import annotations

# -- engine query path -------------------------------------------------
ENGINE_UPLOAD = "engine.upload"
ENGINE_DISPATCH_FLAT = "engine.dispatch_flat"
ENGINE_DISPATCH_PADDED = "engine.dispatch_padded"
ENGINE_SOLVE = "engine.solve"
ENGINE_SAMPLED_SOLVE = "engine.sampled_solve"
ENGINE_CACHE_PUBLISH = "engine.cache_publish"
ENGINE_FACTOR_LOAD = "engine.factor_load"

# -- factor bank (precomputed iHVP tier) -------------------------------
FACTOR_PUBLISH = "factor.publish"

# -- full-parameter engine ---------------------------------------------
FULL_SOLVE = "full.solve"

# -- training ----------------------------------------------------------
TRAINER_EPOCH = "trainer.epoch"
TRAINER_LOO_SEGMENT = "trainer.loo_segment"
CHECKPOINT_PUBLISH = "checkpoint.publish"

# -- distributed runtime -----------------------------------------------
DISTRIBUTED_PUT_GLOBAL = "distributed.put_global"

# -- artifact integrity layer ------------------------------------------
ARTIFACTS_PUBLISH = "artifacts.publish"

# -- serving -----------------------------------------------------------
SERVE_DISPATCH = "serve.dispatch"
SERVE_CACHE_PUBLISH = "serve.cache_publish"

# -- device-loss recovery ----------------------------------------------
MESH_REBUILD = "mesh.rebuild"

# -- host-loss recovery ------------------------------------------------
HOST_LOST = "host.lost"
MESH_REBUILD_MULTIHOST = "mesh.rebuild_multihost"

# -- streaming updates -------------------------------------------------
STREAM_UPDATE = "stream.update"
STREAM_SWAP = "stream.swap"

# -- audit / unlearning (docs/design.md §23) ---------------------------
AUDIT_SWEEP = "audit.sweep"
AUDIT_APPLY = "audit.apply"

# -- chaos scenario engine ---------------------------------------------
CHAOS_SCENARIO = "chaos.scenario"
CHAOS_UNIT = "chaos.unit"

ALL_SITES = frozenset({
    ENGINE_UPLOAD,
    ENGINE_DISPATCH_FLAT,
    ENGINE_DISPATCH_PADDED,
    ENGINE_SOLVE,
    ENGINE_SAMPLED_SOLVE,
    ENGINE_CACHE_PUBLISH,
    ENGINE_FACTOR_LOAD,
    FACTOR_PUBLISH,
    FULL_SOLVE,
    TRAINER_EPOCH,
    TRAINER_LOO_SEGMENT,
    CHECKPOINT_PUBLISH,
    DISTRIBUTED_PUT_GLOBAL,
    ARTIFACTS_PUBLISH,
    SERVE_DISPATCH,
    SERVE_CACHE_PUBLISH,
    MESH_REBUILD,
    HOST_LOST,
    MESH_REBUILD_MULTIHOST,
    STREAM_UPDATE,
    STREAM_SWAP,
    AUDIT_SWEEP,
    AUDIT_APPLY,
    CHAOS_SCENARIO,
    CHAOS_UNIT,
})


def check(site: str) -> str:
    """Validate ``site`` against the registry; returns it unchanged.

    For callers that construct site names dynamically (the linter can
    only see literals): raising here turns a plan that could never fire
    into a loud error instead of a test that silently stops testing.
    """
    if site not in ALL_SITES:
        raise ValueError(
            f"unknown injection site {site!r}; registered sites live in "
            "fia_tpu/reliability/sites.py"
        )
    return site
