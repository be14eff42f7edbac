"""The FIA5xx call-graph determinism family of the port's lint engine
(fia_tpu_torch/analysis): source→sink taint engine fixtures,
interprocedural resolution, suppression-at-source semantics, the
baseline workflow, and the live-port clean invariant — restating
``tests/test_dataflow.py`` port against port, plus torch's global and
unseeded generators as FIA501 sources.

Same shape as test_analysis.py: each rule gets a bad fixture (proves
detection — the live repo is clean, so a silently-broken rule would
look like a passing gate) and a good fixture (proves the idiomatic
form doesn't false-positive). Mini-repos are written under tmp_path
with a pyproject.toml root. A *source alone is never a finding* — the
engine only flags completed flows into byte-pinned sinks — so every
bad fixture routes the value into a registered sink and every
"source without sink" fixture asserts clean.
"""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap

import torch

from fia_tpu_torch.analysis.core import lint_paths
from fia_tpu_torch.analysis.lint import main as lint_main

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FIA5 = {"FIA501", "FIA502", "FIA503", "FIA504", "FIA505", "FIA506"}


def _mini_repo(tmp_path, files: dict[str, str]):
    (tmp_path / "pyproject.toml").write_text("[project]\nname='x'\n")
    paths = []
    for rel, body in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(body))
        paths.append(str(p))
    return paths


def _lint5(tmp_path, files, select=FIA5):
    paths = _mini_repo(tmp_path, files)
    return lint_paths(paths, root=str(tmp_path), select=set(select))


def _rules_hit(result):
    return {f.rule for f in result.findings}


class TestUnseededRng:
    def test_global_draw_to_sink(self, tmp_path):
        res = _lint5(tmp_path, {"m.py": """\
            import numpy as np
            from fia_tpu_torch.utils.io import save_npz_atomic

            def emit(path):
                noise = np.random.rand(4)
                save_npz_atomic(path, noise)
        """})
        assert _rules_hit(res) == {"FIA501"}
        (f,) = res.findings
        assert f.line == 5  # anchored at the SOURCE, not the sink
        assert "np.random" in f.message or "numpy.random" in f.message
        assert "(chain: emit)" in f.message

    def test_unseeded_default_rng_to_sink(self, tmp_path):
        res = _lint5(tmp_path, {"m.py": """\
            import numpy as np
            from fia_tpu_torch.utils.io import save_npz_atomic

            def emit(path):
                rng = np.random.default_rng()
                save_npz_atomic(path, rng.normal(size=3))
        """})
        assert _rules_hit(res) == {"FIA501"}

    def test_seeded_generator_clean(self, tmp_path):
        res = _lint5(tmp_path, {"m.py": """\
            import numpy as np
            from fia_tpu_torch.utils.io import save_npz_atomic

            def emit(path, seed):
                rng = np.random.default_rng(seed)
                save_npz_atomic(path, rng.normal(size=3))
        """})
        assert res.ok, [f.render() for f in res.findings]

    def test_source_without_sink_clean(self, tmp_path):
        res = _lint5(tmp_path, {"m.py": """\
            import numpy as np

            def jitter():
                return float(np.random.rand())
        """})
        assert res.ok, [f.render() for f in res.findings]

    def test_metrics_event_is_a_sink_for_rng(self, tmp_path):
        res = _lint5(tmp_path, {"m.py": """\
            import numpy as np

            def emit(log):
                v = np.random.rand()
                log.log("serve.batch", v=v)
        """})
        assert _rules_hit(res) == {"FIA501"}
        assert "metrics event 'serve.batch'" in res.findings[0].message


class TestTorchRng:
    """torch's counterpart of the numpy and ``random`` sources."""

    def test_global_torch_draw_to_sink(self, tmp_path):
        res = _lint5(tmp_path, {"m.py": """\
            import torch
            from fia_tpu_torch.utils.io import save_npz_atomic

            def emit(path):
                noise = torch.randn(4)
                perm = torch.randperm(4)
                save_npz_atomic(path, noise.numpy(), perm.numpy())
        """})
        assert _rules_hit(res) == {"FIA501"}
        assert sorted(f.line for f in res.findings) == [5, 6]
        assert "torch.randn (global RNG draw)" in res.findings[0].message

    def test_unseeded_generator_to_sink(self, tmp_path):
        res = _lint5(tmp_path, {"m.py": """\
            import torch
            from fia_tpu_torch.utils.io import save_npz_atomic

            def emit(path):
                g = torch.Generator()
                x = torch.rand(3, generator=g)
                save_npz_atomic(path, x.numpy())
        """})
        assert _rules_hit(res) == {"FIA501"}
        (f,) = res.findings
        assert f.line == 5 and "never seeded" in f.message

    def test_seeded_generators_clean(self, tmp_path):
        res = _lint5(tmp_path, {"m.py": """\
            import torch
            from fia_tpu_torch.utils.io import save_npz_atomic

            def emit(path, seed):
                g = torch.Generator().manual_seed(seed)
                h = torch.Generator(device="cpu")
                h.manual_seed(seed + 1)
                x = torch.rand(3, generator=g)
                y = torch.multinomial(torch.ones(4), 2, generator=h)
                save_npz_atomic(path, x.numpy(), y.numpy())
        """})
        assert res.ok, [f.render() for f in res.findings]

    def test_torch_draw_without_sink_clean(self, tmp_path):
        res = _lint5(tmp_path, {"m.py": """\
            import torch

            def jitter():
                return float(torch.rand(()))
        """})
        assert res.ok, [f.render() for f in res.findings]


class TestWallclock:
    def test_wallclock_to_artifact(self, tmp_path):
        res = _lint5(tmp_path, {"m.py": """\
            import time
            from fia_tpu_torch.utils.io import save_json_atomic

            def emit(path):
                t0 = time.time()
                save_json_atomic(path, {"started": t0})
        """})
        assert _rules_hit(res) == {"FIA502"}
        assert "wall-clock" in res.findings[0].message

    def test_wallclock_to_metrics_event_exempt(self, tmp_path):
        # timestamps in the event stream ARE the observability
        # contract: event emission is not a FIA502 sink
        res = _lint5(tmp_path, {"m.py": """\
            import time

            def emit(log):
                log.log("obs.span", t=time.time())
        """})
        assert res.ok, [f.render() for f in res.findings]

    def test_seam_module_exempt(self, tmp_path):
        res = _lint5(tmp_path, {"fia_tpu_torch/reliability/policy.py": """\
            import time
            from fia_tpu_torch.utils.io import save_json_atomic

            def checkpoint_clock(path):
                save_json_atomic(path, {"now": time.monotonic()})
        """})
        assert res.ok, [f.render() for f in res.findings]


class TestFsOrder:
    def test_unsorted_listdir_to_sink(self, tmp_path):
        res = _lint5(tmp_path, {"m.py": """\
            import os
            from fia_tpu_torch.utils.io import save_json_atomic

            def manifest(d, path):
                files = os.listdir(d)
                save_json_atomic(path, {"files": files})
        """})
        assert _rules_hit(res) == {"FIA503"}

    def test_sorted_listdir_clean(self, tmp_path):
        res = _lint5(tmp_path, {"m.py": """\
            import os
            from fia_tpu_torch.utils.io import save_json_atomic

            def manifest(d, path):
                files = sorted(os.listdir(d))
                save_json_atomic(path, {"files": files})
        """})
        assert res.ok, [f.render() for f in res.findings]

    def test_sorted_reassignment_strong_update(self, tmp_path):
        # checkpoint.generations() idiom: listing is sanitised by a
        # later sorted() over the same name
        res = _lint5(tmp_path, {"m.py": """\
            import os
            from fia_tpu_torch.utils.io import save_json_atomic

            def manifest(d, path):
                files = os.listdir(d)
                files = sorted(files)
                save_json_atomic(path, {"files": files})
        """})
        assert res.ok, [f.render() for f in res.findings]


class TestJsonSortKeys:
    def test_raw_dump_flagged_directly(self, tmp_path):
        res = _lint5(tmp_path, {"m.py": """\
            import json

            def emit(obj, fh):
                json.dump(obj, fh)
        """})
        assert _rules_hit(res) == {"FIA504"}

    def test_sorted_dump_clean(self, tmp_path):
        res = _lint5(tmp_path, {"m.py": """\
            import json

            def emit(obj, fh):
                json.dump(obj, fh, sort_keys=True)
        """})
        assert res.ok, [f.render() for f in res.findings]

    def test_dumps_needs_a_sink(self, tmp_path):
        res = _lint5(tmp_path, {"m.py": """\
            import json
            from fia_tpu_torch.utils.io import save_text_atomic

            def stringify(obj):
                return json.dumps(obj)  # local use only: fine

            def emit(obj, path):
                save_text_atomic(path, json.dumps(obj))  # pinned: not
        """})
        assert [f.rule for f in res.findings] == ["FIA504"]
        assert res.findings[0].line == 8


class TestSetOrder:
    def test_set_iteration_to_sink(self, tmp_path):
        res = _lint5(tmp_path, {"m.py": """\
            from fia_tpu_torch.utils.io import save_json_atomic

            def emit(xs, path):
                seen = set(xs)
                save_json_atomic(path, {"seen": [x for x in seen]})
        """})
        assert _rules_hit(res) == {"FIA505"}
        assert "set iteration order" in res.findings[0].message

    def test_sorted_set_clean(self, tmp_path):
        res = _lint5(tmp_path, {"m.py": """\
            from fia_tpu_torch.utils.io import save_json_atomic

            def emit(xs, path):
                seen = set(xs)
                save_json_atomic(path, {"seen": sorted(seen)})
        """})
        assert res.ok, [f.render() for f in res.findings]


class TestIdentityOrdering:
    def test_sort_key_id_to_sink(self, tmp_path):
        res = _lint5(tmp_path, {"m.py": """\
            from fia_tpu_torch.utils.io import save_json_atomic

            def emit(objs, path):
                ordered = sorted(objs, key=id)
                save_json_atomic(path, {"order": ordered})
        """})
        assert _rules_hit(res) == {"FIA506"}

    def test_hash_value_to_sink(self, tmp_path):
        res = _lint5(tmp_path, {"m.py": """\
            from fia_tpu_torch.utils.io import save_json_atomic

            def emit(obj, path):
                save_json_atomic(path, {"h": hash(obj)})
        """})
        assert _rules_hit(res) == {"FIA506"}

    def test_plain_sorted_clean(self, tmp_path):
        res = _lint5(tmp_path, {"m.py": """\
            from fia_tpu_torch.utils.io import save_json_atomic

            def emit(objs, path):
                save_json_atomic(path, {"order": sorted(objs)})
        """})
        assert res.ok, [f.render() for f in res.findings]


class TestInterprocedural:
    def test_cross_module_source_to_sink(self, tmp_path):
        """The tentpole case: source in one module, sink call in
        another, joined only through the project call graph."""
        res = _lint5(tmp_path, {
            "gen.py": """\
                import numpy as np

                def make_noise(n):
                    return np.random.rand(n)
            """,
            "writer.py": """\
                from gen import make_noise
                from fia_tpu_torch.utils.io import save_npz_atomic

                def emit(path):
                    save_npz_atomic(path, make_noise(4))
            """,
        })
        assert _rules_hit(res) == {"FIA501"}
        (f,) = res.findings
        assert f.path == "gen.py"          # anchored at the source...
        assert "writer.py" in f.message    # ...naming the distant sink
        assert "make_noise -> emit" in f.message

    def test_taint_through_intermediate_hop(self, tmp_path):
        res = _lint5(tmp_path, {"m.py": """\
            import numpy as np
            from fia_tpu_torch.utils.io import save_npz_atomic

            def draw():
                return np.random.rand(3)

            def shape_it():
                return draw().reshape(3, 1)

            def emit(path):
                save_npz_atomic(path, shape_it())
        """})
        assert _rules_hit(res) == {"FIA501"}
        assert "draw -> shape_it -> emit" in res.findings[0].message

    def test_transform_wrapped_source_resolves(self, tmp_path):
        # module-level alias through a torch function transform: the
        # FIA2xx unwrap machinery feeds the call graph, so
        # `run = torch.func.vmap(_impl)` still carries _impl's taint
        res = _lint5(tmp_path, {"m.py": """\
            import numpy as np
            import torch
            from fia_tpu_torch.utils.io import save_npz_atomic

            def _impl(n):
                return np.random.rand(n)

            run = torch.func.vmap(_impl)

            def emit(path):
                save_npz_atomic(path, run(4))
        """})
        assert _rules_hit(res) == {"FIA501"}

    def test_tainted_param_into_sinking_helper(self, tmp_path):
        # param_sinks half of the summary: the helper sinks its
        # argument; the caller supplies the taint
        res = _lint5(tmp_path, {"m.py": """\
            import time
            from fia_tpu_torch.utils.io import save_json_atomic

            def persist(path, payload):
                save_json_atomic(path, payload)

            def emit(path):
                persist(path, {"t": time.time()})
        """})
        assert _rules_hit(res) == {"FIA502"}
        assert "emit -> persist" in res.findings[0].message

    def test_dispatch_return_is_a_sink(self, tmp_path):
        # DETERMINISM_SINK_RETURNS: the dispatch path's return value is
        # byte-pinned by the sharded-vs-replicated identity contract
        res = _lint5(tmp_path, {"fia_tpu_torch/influence/engine.py": """\
            import numpy as np

            def query_many(queries):
                jitter = np.random.rand(len(queries))
                return jitter
        """})
        assert _rules_hit(res) == {"FIA501"}
        assert "dispatch-path" in res.findings[0].message


class TestSuppression:
    BAD = """\
        import numpy as np
        from fia_tpu_torch.utils.io import save_npz_atomic

        def make():
            return np.random.rand(4){src_comment}

        def emit(path):
            save_npz_atomic(path, make()){sink_comment}
    """

    def _fixture(self, src_comment="", sink_comment=""):
        return {"m.py": self.BAD.replace(
            "{src_comment}", src_comment
        ).replace("{sink_comment}", sink_comment)}

    def test_unsuppressed_flow_found(self, tmp_path):
        res = _lint5(tmp_path, self._fixture())
        assert _rules_hit(res) == {"FIA501"}

    def test_suppression_at_source_kills_the_chain(self, tmp_path):
        res = _lint5(tmp_path, self._fixture(
            src_comment="  # fialint: disable=FIA501 -- deliberate: "
                        "synthetic fixture noise",
        ))
        assert res.ok, [f.render() for f in res.findings]
        assert any(s.rule == "FIA501" for s in res.suppressed)

    def test_suppression_at_sink_also_accepted(self, tmp_path):
        # the finding re-anchors to the sink line when only the sink
        # carries the suppression — either end may take responsibility
        res = _lint5(tmp_path, self._fixture(
            sink_comment="  # fialint: disable=FIA501 -- published "
                         "fixture is allowed to vary",
        ))
        assert res.ok, [f.render() for f in res.findings]
        assert any(s.rule == "FIA501" for s in res.suppressed)


class TestCLI:
    def test_family_prefix_select(self, tmp_path):
        paths = _mini_repo(tmp_path, {"m.py": """\
            import json

            def emit(obj, fh):
                json.dump(obj, fh)
        """})
        # FIA5 expands to the whole family; exact ids still work
        assert lint_main(["--select", "FIA5", *paths]) == 1
        assert lint_main(["--select", "FIA504", *paths]) == 1
        assert lint_main(["--select", "FIA501", *paths]) == 0

    def test_baseline_round_trip(self, tmp_path):
        paths = _mini_repo(tmp_path, {"m.py": """\
            import json

            def emit(obj, fh):
                json.dump(obj, fh)
        """})
        snap = str(tmp_path / "baseline.json")
        assert lint_main([*paths, "--write-baseline", snap]) == 0
        # pre-existing findings: tolerated under the baseline
        assert lint_main([*paths, "--baseline", snap]) == 1 - 1
        # a NEW finding (another file) breaks through the baseline
        extra = _mini_repo(tmp_path, {"n.py": """\
            import json

            def emit2(obj, fh):
                json.dump(obj, fh)
        """})
        assert lint_main([*paths, *extra, "--baseline", snap]) == 1

    def test_live_repo_fia5_self_check_clean(self):
        """The acceptance invariant: zero unsuppressed FIA5xx findings
        on the live port, every suppression justified (an unjustified
        one surfaces as FIA001 and fails the run)."""
        proc = subprocess.run(
            [sys.executable, "-m", "fia_tpu_torch.analysis.lint",
             "--select", "FIA5", "--self-check"],
            capture_output=True, text=True, cwd=REPO,
        )
        assert proc.returncode == 0, proc.stdout + proc.stderr
