"""Chaos scenario engine: seeded fault schedules, end-to-end invariant
oracles, and automatic schedule shrinking (port of ``fia_tpu/chaos``).

Influence pipelines fail in *composed* ways — solver state ×
checkpoint state × batching ("Scaling Up Influence Functions",
arXiv:2112.03052) — so this package turns the reliability layer's
one-fault-at-a-time harnesses into one soak layer:

- :mod:`~fia_tpu_torch.chaos.schedule` — seeded, replayable fault
  schedules drawn from the checked-in site registry (the reference's
  schedules and JSON bytes);
- :mod:`~fia_tpu_torch.chaos.scenarios` — real end-to-end workloads
  (train→checkpoint→kill→resume, journaled ``query_many`` over a
  damaged disk tier, serving under dispatch faults, overload, device
  and host loss, the factor bank, streaming updates and unlearning
  while serving, brownout, multi-tenant admission) driven through the
  port's production entry points under virtual time;
- :mod:`~fia_tpu_torch.chaos.oracles` — invariants checked after every
  run: bit-identical results vs. an undisturbed golden run, classified
  errors only, armed ⇒ fired-or-reported fault accounting, on-disk
  artifact detectability;
- :mod:`~fia_tpu_torch.chaos.shrink` — delta debugging (ddmin) reduces
  a failing schedule to a minimal reproducing fault sequence;
- :mod:`~fia_tpu_torch.chaos.runner` — the engine tying them together
  and emitting replayable repro JSON, which either package loads
  (``python -m fia_tpu_torch.cli.chaos --replay repro.json``).

Entry point: ``python -m fia_tpu_torch.cli.chaos`` (``--smoke`` for the
fixed-seed battery; ``--backend cpu`` on the CPU).
"""

from fia_tpu_torch.chaos.runner import ChaosEngine, ChaosReport  # noqa: F401
from fia_tpu_torch.chaos.schedule import (  # noqa: F401
    ChaosFault,
    Schedule,
    generate,
)
