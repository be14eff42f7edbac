"""The port's lint engine (``fia_tpu_torch/analysis``): rule detection
fixtures, suppression semantics, reporters, and the self-check-clean
invariant, restating ``tests/test_analysis.py`` port against port.

Each rule family gets a good/bad fixture pair: the bad fixture proves
the rule *detects* its violation class (the live port is clean, so
without fixtures a silently-broken rule would look like a passing gate),
the good fixture proves the idiomatic form doesn't false-positive.
Fixtures are written into tmp mini-repos (pyproject.toml marks the root)
so the cross-file ProjectRules resolve their registries relative to the
fixture, not this repo. The FIA2xx fixtures are in the port's idiom:
programs captured as CUDA graphs and torch transfers; the six shapes the
reference's jit model flagged on the port's kernel wrappers are clean
cases here. The rules whose meaning carries over unchanged (FIA101,
FIA30x, FIA40x, FIA50x) are held to the reference's engine on shared
fixtures, rule for rule.
"""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from fia_tpu.analysis import core as ref_core
from fia_tpu_torch.analysis import config
from fia_tpu_torch.analysis.core import lint_paths
from fia_tpu_torch.analysis.lint import self_check_paths
from fia_tpu_torch.analysis.reporters import json_report, terminal_report

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mini_repo(tmp_path, files: dict[str, str]):
    """Write a fixture tree under tmp_path with a pyproject.toml root."""
    (tmp_path / "pyproject.toml").write_text("[project]\nname='x'\n")
    paths = []
    for rel, body in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(body))
        paths.append(str(p))
    return paths


def _lint(tmp_path, files, **kw):
    paths = _mini_repo(tmp_path, files)
    return lint_paths(paths, root=str(tmp_path), **kw)


def _rules_hit(result):
    return {f.rule for f in result.findings}


class TestRawWrite:
    def test_bad_raw_writes_flagged(self, tmp_path):
        res = _lint(tmp_path, {"scripts/report.py": """\
            import json
            import numpy as np
            from pathlib import Path

            def dump(path, obj, arr):
                with open(path, "w") as fh:
                    json.dump(obj, fh)
                np.save(path, arr)
                np.savetxt(path, arr)
                Path(path).write_text("x")
        """}, select={"FIA101"})
        assert _rules_hit(res) == {"FIA101"}
        assert len(res.findings) == 5  # open, json.dump, save, savetxt, write_text

    def test_good_forms_clean(self, tmp_path):
        res = _lint(tmp_path, {"scripts/report.py": """\
            from fia_tpu_torch.utils.io import save_json_atomic

            def dump(path, obj, log_path):
                save_json_atomic(path, obj)
                with open(path) as fh:        # read is fine
                    fh.read()
                with open(log_path, "a") as fh:  # append-only journal idiom
                    fh.write("line")
        """})
        assert res.ok, [f.render() for f in res.findings]

    def test_allowlisted_module_exempt(self, tmp_path):
        res = _lint(tmp_path, {"fia_tpu_torch/utils/io.py": """\
            import json

            def save(path, obj):
                with open(path, "w") as fh:
                    json.dump(obj, fh)
        """}, select={"FIA101"})
        assert res.ok, [f.render() for f in res.findings]


class TestTraceHygiene:
    """FIA201-203 on programs captured as CUDA graphs."""

    def test_bad_host_sync_and_branch(self, tmp_path):
        res = _lint(tmp_path, {"fia_tpu_torch/kernels.py": """\
            import numpy as np
            import torch

            def f(x):
                y = torch.sum(x)
                if y > 0:
                    print("positive")
                v = float(y)
                z = np.asarray(y)
                w = torch.tensor([1.0, 2.0], device=x.device)
                torch.cuda.synchronize()
                return y.item()

            graph = torch.cuda.CUDAGraph()
            static_x = torch.zeros(8, device="cuda")
            with torch.cuda.graph(graph):
                out = f(static_x)
        """})
        assert "FIA201" in _rules_hit(res)
        assert "FIA202" in _rules_hit(res)
        msgs = " ".join(f.message for f in res.findings)
        for want in ("print()", ".item()", "float()", "numpy call",
                     "synchronize", "torch.tensor()"):
            assert want in msgs, want

    def test_bad_graphed_callable_form_detected(self, tmp_path):
        # capture by make_graphed_callables, not a with block
        res = _lint(tmp_path, {"fia_tpu_torch/kernels.py": """\
            import torch

            def solve(x):
                if x.sum() > 0:
                    return torch.zeros(())
                return torch.ones(())

            solve_fast = torch.cuda.make_graphed_callables(
                solve, (torch.zeros(4, device="cuda"),))
        """})
        assert _rules_hit(res) == {"FIA202"}

    def test_good_static_branch_clean(self, tmp_path):
        """The port's kernel-wrapper idiom: device checks, geometry ints,
        data_ptr alignment, an optional argument and a ctypes entry's
        return code are host values fixed at capture."""
        res = _lint(tmp_path, {"fia_tpu_torch/kernels.py": """\
            import ctypes

            import torch

            _fn = ctypes.CDLL("libk.so").k

            def scores(rel_x, P, B, mask=None):
                if rel_x.device.type == "cpu":
                    return rel_x.sum(1).float()
                if rel_x.device.type != "cuda":
                    raise ValueError("unsupported device")
                S, k = rel_x.shape[0], P.shape[1]
                out = torch.empty((S,), dtype=torch.float32,
                                  device=rel_x.device)
                if S == 0:
                    return out
                if mask is not None:
                    out = out * mask
                vec4 = k % 4 == 0 and all(x.data_ptr() % 16 == 0
                                          for x in (P, B))
                rc = _fn(rel_x.data_ptr(), P.data_ptr(), out.data_ptr(),
                         S, k, int(vec4))
                if rc != 0:
                    raise RuntimeError(rc)
                return torch.where(out > 0, out, 0.0)

            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                res = scores(static_rel, static_P, static_B)
        """})
        assert res.ok, [f.render() for f in res.findings]

    def test_bad_closure_capture(self, tmp_path):
        res = _lint(tmp_path, {"fia_tpu_torch/kernels.py": """\
            import torch

            def build(n, idx):
                table = torch.zeros((n, 4))

                def gather(i):
                    return torch.sum(table[i])

                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    out = gather(idx)
                table = torch.ones((n, 4))  # replaced: the graph reads the old
                return graph, out
        """})
        assert _rules_hit(res) == {"FIA203"}
        (f,) = res.findings
        assert "table" in f.message and f.line == 6

    def test_good_capture_as_argument_clean(self, tmp_path):
        res = _lint(tmp_path, {"fia_tpu_torch/kernels.py": """\
            import torch

            def build(n, idx):
                table = torch.zeros((n, 4))

                def gather(i):
                    return torch.sum(table[i])

                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    out = gather(idx)
                table.copy_(torch.ones((n, 4)))  # in place: replays see it
                return graph, out
        """})
        assert res.ok, [f.render() for f in res.findings]


# The six lines the reference's jit model flagged on the port's kernel
# wrappers (kernels/mf.py, ncf.py, __init__.py), each in the wrapper's own
# shape, inside a capture: all host values fixed at capture time.
FALSE_POSITIVE_SHAPES = {
    "mf_empty_batch": """\
        def w(rel_x, P):
            S = rel_x.shape[0]
            out = torch.empty((S,), device=rel_x.device)
            if S == 0:
                return out
            return out
    """,
    "mf_alignment_flag": """\
        def w(rel_x, P, Q, B):
            k = P.shape[1]
            vec4 = k % 4 == 0 and all(x.data_ptr() % 16 == 0
                                      for x in (P, Q, B))
            return _fn(rel_x.data_ptr(), int(vec4))
    """,
    "mf_return_code": """\
        def w(rel_x, P):
            out = torch.empty_like(rel_x)
            rc = _fn(rel_x.data_ptr(), P.data_ptr(), out.data_ptr(),
                     rel_x.shape[0])
            if rc != 0:
                raise RuntimeError(rc)
            return out
    """,
    "ncf_geometry_tuple": """\
        def w(rel_x, tx, P_mlp, W2):
            S, T, k, k2 = rel_x.shape[0], tx.shape[0], P_mlp.shape[1], \\
                W2.shape[1]
            out = torch.empty((S,), device=rel_x.device)
            if S == 0:
                return out
            return out
    """,
    "ncf_return_code_of_pointer_pack": """\
        def w(rel_x, t, B):
            args = (rel_x, t, B)
            out = torch.empty((rel_x.shape[0],), device=rel_x.device)
            rc = _fn(*(x.data_ptr() for x in args), out.data_ptr(),
                     rel_x.shape[0])
            if rc != 0:
                raise RuntimeError(rc)
            return out
    """,
    "dispatch_device_check": """\
        def w(rel_x, B):
            if rel_x.device.type != "cuda":
                raise ValueError(f"tensors on {rel_x.device}")
            return rel_x * B
    """,
}


@pytest.mark.parametrize("shape", sorted(FALSE_POSITIVE_SHAPES))
def test_capture_static_values_clean(tmp_path, shape):
    body = textwrap.dedent(FALSE_POSITIVE_SHAPES[shape])
    src = ("import torch\n\n_fn = None\n\n" + body
           + "\n\ng = torch.cuda.make_graphed_callables(w, ())\n")
    res = _lint(tmp_path, {"fia_tpu_torch/kernels/w.py": src},
                select={"FIA201", "FIA202", "FIA203"})
    assert res.ok, [f.render() for f in res.findings]


def test_port_kernel_wrappers_clean():
    """The wrappers whose lines those were lint clean under the capture
    family, with no suppression."""
    paths = [os.path.join(REPO, "fia_tpu_torch", "influence", "kernels", f)
             for f in ("mf.py", "ncf.py", "__init__.py")]
    res = lint_paths(paths, select={"FIA201", "FIA202", "FIA203"}, root=REPO)
    assert res.ok and not res.suppressed, [f.render() for f in res.findings]


class TestDispatchPath:
    """FIA204: no per-query host→device transfers on the registered
    dispatch hot path."""

    _ENGINE = "fia_tpu_torch/influence/engine.py"

    def test_transfer_in_loop_flagged(self, tmp_path):
        res = _lint(tmp_path, {self._ENGINE: """\
            import torch

            def _dispatch_flat(points, dev):
                out = []
                for p in points:
                    out.append(torch.as_tensor(p, device=dev))
                    out.append(torch.from_numpy(p).to(dev))
                return out
        """}, select={"FIA204"})
        assert [f.rule for f in res.findings] == ["FIA204", "FIA204"]
        assert "_dispatch_flat" in res.findings[0].message

    def test_hoisted_transfer_and_deferred_closure_clean(self, tmp_path):
        res = _lint(tmp_path, {self._ENGINE: """\
            import torch

            def _dispatch_flat(points, dev):
                tx = torch.as_tensor(points, device=dev)  # one per dispatch
                thunks = []
                for p in points:
                    thunks.append(lambda p=p: torch.as_tensor(p))  # deferred
                return tx, thunks
        """}, select={"FIA204"})
        assert res.ok, [f.render() for f in res.findings]

    def test_unregistered_function_not_policed(self, tmp_path):
        res = _lint(tmp_path, {self._ENGINE: """\
            import torch

            def some_helper(points, dev):
                for p in points:
                    torch.as_tensor(p, device=dev)
        """}, select={"FIA204"})
        assert res.ok

    def test_device_moves_in_loop_clean(self, tmp_path):
        # the sharded gather's idiom: partials of device tensors move
        # between devices (and dtype casts), never host data
        res = _lint(tmp_path, {"fia_tpu_torch/parallel/sharded.py": """\
            import torch

            def gather_table_rows(tables, ids, home):
                acc = None
                for tl in tables:
                    loc = ids.to(tl.device)
                    part = tl[loc.long()].to(torch.float32).to(home)
                    acc = part if acc is None else acc + part
                return acc
        """}, select={"FIA204", "FIA205"})
        assert res.ok, [f.render() for f in res.findings]

    def test_real_dispatch_path_is_clean(self):
        """The rule holds on the port: the registered dispatch functions
        perform no in-loop transfers, so FIA204 acts as a regression
        tripwire, not a TODO list."""
        paths = sorted({os.path.join(REPO, p)
                        for p, _ in config.DISPATCH_PATH_FUNCTIONS})
        res = lint_paths(paths, select={"FIA204"}, root=REPO)
        assert res.ok, [f.render() for f in res.findings]


class TestUnshardedTransfer:
    """FIA205: no placement outside the mesh helpers on the registered
    dispatch path."""

    _ENGINE = "fia_tpu_torch/influence/engine.py"

    def test_unsharded_device_put_flagged(self, tmp_path):
        res = _lint(tmp_path, {self._ENGINE: """\
            import torch

            def _dispatch_flat(sh, dev):
                tx = torch.as_tensor(sh, device=dev)
                return tx
        """}, select={"FIA205"})
        assert [f.rule for f in res.findings] == ["FIA205"]
        assert "_dispatch_flat" in res.findings[0].message
        assert "put_global" in res.findings[0].message

    def test_sharded_and_helper_placements_clean(self, tmp_path):
        res = _lint(tmp_path, {self._ENGINE: """\
            import torch
            from fia_tpu_torch.parallel.distributed import put_global
            from fia_tpu_torch.parallel.mesh import replicate, shard_along

            def _dispatch_flat(mesh, sh, params):
                a = put_global(mesh, sh, "data")  # the parallel/ helpers
                b = shard_along(mesh, sh)
                c = replicate(mesh, params)
                d = torch.as_tensor(sh)  # a host tensor: no placement
                return a, b, c, d
        """}, select={"FIA205"})
        assert res.ok, [f.render() for f in res.findings]

    def test_unregistered_function_not_policed(self, tmp_path):
        res = _lint(tmp_path, {self._ENGINE: """\
            import torch

            def some_helper(sh, dev):
                return torch.as_tensor(sh, device=dev)
        """}, select={"FIA205"})
        assert res.ok

    def test_real_dispatch_path_is_clean(self):
        paths = sorted({os.path.join(REPO, p)
                        for p, _ in config.DISPATCH_PATH_FUNCTIONS})
        res = lint_paths(paths, select={"FIA205"}, root=REPO)
        assert res.ok, [f.render() for f in res.findings]


_SITES_FIXTURE = """\
    GOOD = "engine.solve"
    ALL_SITES = frozenset({GOOD})
"""


class TestSiteIntegrity:
    def test_bad_unregistered_literal(self, tmp_path):
        res = _lint(tmp_path, {
            "fia_tpu_torch/reliability/sites.py": _SITES_FIXTURE,
            "fia_tpu_torch/engine.py": """\
                from fia_tpu_torch.reliability import inject

                def solve():
                    inject.fire("engine.solve")
                    inject.fire("engine.sovle")  # typo'd site
            """,
        }, select={"FIA301"})
        assert _rules_hit(res) == {"FIA301"}
        (f,) = res.findings
        assert "engine.sovle" in f.message
        assert "fia_tpu_torch/reliability/sites.py" in f.message

    def test_bad_unknown_constant(self, tmp_path):
        res = _lint(tmp_path, {
            "fia_tpu_torch/reliability/sites.py": _SITES_FIXTURE,
            "fia_tpu_torch/engine.py": """\
                from fia_tpu_torch.reliability import inject, sites

                def solve():
                    inject.fire(sites.ENGINE_SOVLE)
            """,
        }, select={"FIA301"})
        assert _rules_hit(res) == {"FIA301"}

    def test_good_registered_forms_clean(self, tmp_path):
        res = _lint(tmp_path, {
            "fia_tpu_torch/reliability/sites.py": _SITES_FIXTURE,
            "fia_tpu_torch/engine.py": """\
                from fia_tpu_torch.reliability import inject, sites

                def solve(site_var):
                    inject.fire("engine.solve")
                    inject.fire(sites.GOOD)
                    inject.fire(site_var)  # dynamic: sites.check()'s job
            """,
        }, select={"FIA301"})
        assert res.ok, [f.render() for f in res.findings]

    def test_no_registry_demanded_without_site_usage(self, tmp_path):
        res = _lint(tmp_path, {"pkg/mod.py": "x = 1\n"})
        assert res.ok, [f.render() for f in res.findings]

    def test_bad_reliability_raise(self, tmp_path):
        res = _lint(tmp_path, {"fia_tpu_torch/reliability/retry.py": """\
            def attempt():
                raise RuntimeError("unclassifiable")
        """})
        assert _rules_hit(res) == {"FIA302"}

    def test_good_reliability_raises_clean(self, tmp_path):
        res = _lint(tmp_path, {"fia_tpu_torch/reliability/retry.py": """\
            from fia_tpu_torch.reliability import taxonomy

            def attempt(budget):
                if budget < 0:
                    raise ValueError("negative budget")
                try:
                    work()
                except Exception:
                    raise  # bare re-raise: fine
                raise taxonomy.DeadlineExpired("out of budget")
        """})
        assert res.ok, [f.render() for f in res.findings]

    def test_bad_docs_drift_both_directions(self, tmp_path):
        res = _lint(tmp_path, {
            "fia_tpu_torch/reliability/sites.py": """\
                A = "engine.solve"
                B = "engine.upload"
                ALL_SITES = frozenset({A, B})
            """,
            "docs/reliability.md": """\
                # Reliability

                ## Injection-site registry

                | site | where |
                | --- | --- |
                | `engine.solve` | the solve |
                | `engine.stale_row` | removed last PR |
            """,
            "fia_tpu_torch/engine.py": "x = 1\n",
        })
        msgs = [f.message for f in res.findings]
        assert _rules_hit(res) == {"FIA303"}
        assert any("engine.upload" in m and "missing" in m for m in msgs)
        assert any("engine.stale_row" in m and "stale" in m for m in msgs)


_METRICS_FIXTURE = """\
    SCHEMA = {
        "serve.request": ("id", "status", "solve_ms"),
    }

    class EventLog:
        def log(self, event, **fields):
            pass
"""


class TestMetricsSchema:
    def test_bad_undeclared_event_and_field(self, tmp_path):
        res = _lint(tmp_path, {
            "fia_tpu_torch/serve/metrics.py": _METRICS_FIXTURE,
            "fia_tpu_torch/serve/service.py": """\
                def handle(log):
                    log.log("serve.request", id=1, status="ok",
                            latency_ms=3.0)   # renamed field
                    log.log("serve.requets", id=2)  # typo'd event
            """,
        })
        msgs = " ".join(f.message for f in res.findings)
        assert _rules_hit(res) == {"FIA401"}
        assert "latency_ms" in msgs and "serve.requets" in msgs

    def test_bad_consumer_drift(self, tmp_path):
        res = _lint(tmp_path, {
            "fia_tpu_torch/serve/metrics.py": _METRICS_FIXTURE,
            "fia_tpu_torch/serve/service.py": """\
                def handle(log):
                    log.log("serve.request", id=1, status="ok")
            """,
            "scripts/latency_report.py": """\
                CONSUMES = {
                    "serve.request": ("status", "queue_wait_ms"),
                    "serve.batch": ("size",),
                }
            """,
        })
        msgs = " ".join(f.message for f in res.findings)
        assert _rules_hit(res) == {"FIA401"}
        assert "queue_wait_ms" in msgs and "serve.batch" in msgs

    def test_good_schema_agreement_clean(self, tmp_path):
        res = _lint(tmp_path, {
            "fia_tpu_torch/serve/metrics.py": _METRICS_FIXTURE,
            "fia_tpu_torch/serve/service.py": """\
                def handle(log):
                    log.log("serve.request", id=1, status="ok",
                            solve_ms=2.5)
            """,
            "scripts/latency_report.py": """\
                CONSUMES = {"serve.request": ("status", "solve_ms")}
            """,
        })
        assert res.ok, [f.render() for f in res.findings]


_BAD_WRITE = """\
    import json

    def dump(path, obj):{maybe_comment}
        with open(path, "w") as fh:{inline}
            json.dump(obj, fh)
"""


class TestSuppressions:
    def _src(self, inline="", maybe_comment=""):
        return {"scripts/r.py": _BAD_WRITE.format(
            inline=inline, maybe_comment=maybe_comment
        )}

    def test_justified_inline_suppression(self, tmp_path):
        res = _lint(tmp_path, self._src(
            inline="  # fialint: disable=FIA101 -- fixture wants raw bytes"
        ), select={"FIA101"})
        assert [f.rule for f in res.findings] == ["FIA101"]  # json.dump line
        assert any(s.rule == "FIA101" for s in res.suppressed)

    def test_justified_standalone_shields_next_line(self, tmp_path):
        res = _lint(tmp_path, self._src(
            maybe_comment="\n        "
            "# fialint: disable=FIA101 -- fixture wants raw bytes"
        ))
        assert sum(f.rule == "FIA101" for f in res.findings) == 1

    def test_unjustified_suppression_is_a_finding(self, tmp_path):
        res = _lint(tmp_path, self._src(
            inline="  # fialint: disable=FIA101"
        ))
        rules = [f.rule for f in res.findings]
        assert "FIA001" in rules  # the bad suppression itself
        assert "FIA101" in rules  # and it does NOT suppress

    def test_unknown_rule_id_is_a_finding(self, tmp_path):
        res = _lint(tmp_path, self._src(
            inline="  # fialint: disable=FIA999 -- whatever"
        ))
        assert "FIA001" in {f.rule for f in res.findings}

    def test_docstring_mention_is_not_a_suppression(self, tmp_path):
        res = _lint(tmp_path, {"scripts/r.py": '''\
            """Docs may say '# fialint: disable=FIA101' without effect."""

            x = 1
        '''})
        assert res.ok, [f.render() for f in res.findings]

    def test_select_and_disable(self, tmp_path):
        files = {"fia_tpu_torch/reliability/retry.py": """\
            import json

            def attempt(path):
                with open(path, "w") as fh:
                    json.dump({}, fh)
                raise RuntimeError("boom")
        """}
        both = _lint(tmp_path, files)
        assert _rules_hit(both) == {"FIA101", "FIA302", "FIA504"}
        only_io = _lint(tmp_path, files, select={"FIA101"})
        assert _rules_hit(only_io) == {"FIA101"}
        no_io = _lint(tmp_path, files, disable={"FIA101"})
        assert _rules_hit(no_io) == {"FIA302", "FIA504"}


class TestReporters:
    def test_json_report_golden(self, tmp_path):
        res = _lint(tmp_path, {"scripts/r.py": """\
            import json

            def dump(path, obj):
                with open(path, "w") as fh:
                    json.dump(obj, fh)
        """})
        doc = json.loads(json_report(res))
        assert doc["version"] == 1
        assert doc["ok"] is False
        assert doc["files_checked"] == 1
        assert doc["counts"] == {"FIA101": 2, "FIA504": 1}
        first = doc["findings"][0]
        assert set(first) == {"rule", "path", "line", "col", "message"}
        assert first["path"] == "scripts/r.py"
        res2 = lint_paths(
            [str(tmp_path / "scripts" / "r.py")], root=str(tmp_path)
        )
        assert json_report(res2) == json_report(res)

    def test_terminal_report_lines(self, tmp_path):
        res = _lint(tmp_path, {"scripts/r.py": """\
            import numpy as np

            def dump(path, arr):
                np.save(path, arr)
        """})
        out = terminal_report(res)
        assert "scripts/r.py:4:" in out
        assert "FIA101" in out
        assert "1 finding(s)" in out


class TestSelfCheck:
    def test_repo_is_clean(self):
        """The acceptance invariant: the port lints clean, and every
        suppression that exists carries a justification (unjustified
        ones surface as FIA001 findings and fail this)."""
        paths, root = self_check_paths()
        assert paths == [os.path.join(REPO, "fia_tpu_torch")] and root == REPO
        res = lint_paths(paths, root=root)
        assert res.ok, "\n".join(f.render() for f in res.findings)
        assert res.files_checked > 50
        assert {f.path.split("/")[0] for f in res.suppressed} == {
            "fia_tpu_torch"}

    def test_cli_self_check_exit_zero(self):
        proc = subprocess.run(
            [sys.executable, "-m", "fia_tpu_torch.analysis.lint",
             "--self-check"],
            cwd=REPO, capture_output=True, text=True, timeout=120,
        )
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "OK" in proc.stdout

    def test_cli_exit_codes(self, tmp_path):
        bad = tmp_path / "b.py"
        bad.write_text("import json\n\n"
                       "def d(p, o):\n"
                       "    with open(p, 'w') as fh:\n"
                       "        json.dump(o, fh)\n")
        (tmp_path / "pyproject.toml").write_text("[project]\nname='x'\n")
        proc = subprocess.run(
            [sys.executable, "-m", "fia_tpu_torch.analysis.lint", str(bad)],
            cwd=REPO, capture_output=True, text=True, timeout=60,
        )
        assert proc.returncode == 1
        proc = subprocess.run(
            [sys.executable, "-m", "fia_tpu_torch.analysis.lint",
             str(tmp_path / "nope.py")],
            cwd=REPO, capture_output=True, text=True, timeout=60,
        )
        assert proc.returncode == 2


class TestSiteRegistryDocSync:
    def test_registry_sites_all_documented(self):
        """Every site the port registers appears in the
        docs/reliability.md table (the reference's: the port's sites are
        its sites, name for name)."""
        from fia_tpu.reliability import sites as ref_sites
        from fia_tpu_torch.reliability import sites

        doc = open(os.path.join(REPO, "docs", "reliability.md")).read()
        assert "## Injection-site registry" in doc
        assert sites.ALL_SITES == ref_sites.ALL_SITES
        for site in sites.ALL_SITES:
            assert f"`{site}`" in doc, f"{site} missing from docs"

    def test_registry_check(self):
        from fia_tpu_torch.reliability import sites

        sites.check(sites.ENGINE_SOLVE)
        with pytest.raises(ValueError, match="unknown injection site"):
            sites.check("engine.sovle")

    def test_production_fire_sites_are_registered(self):
        res = lint_paths(
            [os.path.join(REPO, "fia_tpu_torch")], select={"FIA301", "FIA303"},
            root=REPO,
        )
        assert res.ok, "\n".join(f.render() for f in res.findings)


# -- rule parity with the reference's engine -------------------------------

# Fixture trees whose rules mean the same in both packages. ``{pkg}``
# becomes ``fia_tpu`` for the reference's engine and ``fia_tpu_torch``
# for the port's, in paths and sources alike; each case names a rule it
# must find (None: both clean).
PARITY_CASES = {
    "raw_writes": ("FIA101", {"{pkg}/report.py": """\
        import json
        import numpy as np
        from pathlib import Path

        def dump(path, obj, arr):
            with open(path, "w") as fh:
                json.dump(obj, fh, sort_keys=True)
            np.save(path, arr)
            Path(path).write_text("x")
    """}),
    "allowlisted_writer": (None, {"{pkg}/utils/io.py": """\
        import json

        def save(path, obj):
            with open(path, "w") as fh:
                json.dump(obj, fh, sort_keys=True)
    """}),
    "unregistered_site": ("FIA301", {
        "{pkg}/reliability/sites.py": _SITES_FIXTURE,
        "{pkg}/engine.py": """\
            from {pkg}.reliability import inject, sites

            def solve():
                inject.fire("engine.solve")
                inject.fire("engine.sovle")
                inject.fire(sites.ENGINE_SOVLE)
        """,
    }),
    "reliability_raise": ("FIA302", {"{pkg}/reliability/retry.py": """\
        def attempt(budget):
            if budget < 0:
                raise ValueError("negative budget")
            raise RuntimeError("unclassifiable")
    """}),
    "docs_drift": ("FIA303", {
        "{pkg}/reliability/sites.py": """\
            A = "engine.solve"
            B = "engine.upload"
            ALL_SITES = frozenset({A, B})
        """,
        "docs/reliability.md": """\
            ## Injection-site registry

            | site | where |
            | --- | --- |
            | `engine.solve` | the solve |
            | `engine.stale_row` | removed |
        """,
        "{pkg}/engine.py": "x = 1\n",
    }),
    "metrics_schema": ("FIA401", {
        "{pkg}/serve/metrics.py": _METRICS_FIXTURE,
        "{pkg}/serve/service.py": """\
            def handle(log):
                log.log("serve.request", id=1, status="ok", latency_ms=3.0)
                log.log("serve.requets", id=2)
        """,
        "scripts/latency_report.py": """\
            CONSUMES = {"serve.request": ("status", "queue_wait_ms")}
        """,
    }),
    "bare_print": ("FIA402", {
        "{pkg}/lib.py": """\
            def report(x):
                print(x)
        """,
        "{pkg}/cli/main.py": """\
            def main():
                print("stdout belongs to CLI mains")
        """,
    }),
    "rng_cross_module": ("FIA501", {
        "{pkg}/gen.py": """\
            import numpy as np

            def make_noise(n):
                return np.random.rand(n)
        """,
        "{pkg}/writer.py": """\
            from {pkg}.gen import make_noise
            from {pkg}.utils.io import save_npz_atomic

            def emit(path):
                save_npz_atomic(path, make_noise(4))
        """,
    }),
    "wallclock": ("FIA502", {
        "{pkg}/m.py": """\
            import time
            from {pkg}.utils.io import save_json_atomic

            def emit(path):
                t0 = time.time()
                save_json_atomic(path, {"started": t0})
        """,
        "{pkg}/reliability/policy.py": """\
            import time
            from {pkg}.utils.io import save_json_atomic

            def checkpoint_clock(path):
                save_json_atomic(path, {"now": time.monotonic()})
        """,
    }),
    "fs_order": ("FIA503", {"{pkg}/m.py": """\
        import os
        from {pkg}.utils.io import save_json_atomic

        def manifest(d, path):
            files = os.listdir(d)
            save_json_atomic(path, {"files": files})
            kept = sorted(os.listdir(d))
            save_json_atomic(path, {"files": kept})
    """}),
    "json_keys": ("FIA504", {"{pkg}/m.py": """\
        import json
        from {pkg}.utils.io import save_text_atomic

        def emit(obj, fh, path):
            json.dump(obj, fh)
            save_text_atomic(path, json.dumps(obj))
            return json.dumps(obj)
    """}),
    "set_order": ("FIA505", {"{pkg}/m.py": """\
        from {pkg}.utils.io import save_json_atomic

        def emit(xs, path):
            seen = set(xs)
            save_json_atomic(path, {"seen": [x for x in seen]})
            save_json_atomic(path, {"seen": sorted(seen)})
    """}),
    "identity": ("FIA506", {"{pkg}/m.py": """\
        from {pkg}.utils.io import save_json_atomic

        def emit(objs, path):
            save_json_atomic(path, {"order": sorted(objs, key=id)})
            save_json_atomic(path, {"h": hash(objs[0])})
    """}),
    "dispatch_return": ("FIA501", {"{pkg}/influence/engine.py": """\
        import numpy as np

        def query_many(queries):
            jitter = np.random.rand(len(queries))
            return jitter
    """}),
}
PARITY_RULES = {"FIA101", "FIA301", "FIA302", "FIA303", "FIA401", "FIA402",
                "FIA501", "FIA502", "FIA503", "FIA504", "FIA505", "FIA506"}


def _case_tree(tmp_path, pkg, files):
    out = {rel.replace("{pkg}", pkg): body.replace("{pkg}", pkg)
           for rel, body in files.items()}
    root = tmp_path / pkg
    root.mkdir()
    return root, _mini_repo(root, out)


@pytest.mark.parametrize("case", sorted(PARITY_CASES))
def test_rule_parity_with_reference_engine(tmp_path, case):
    want, files = PARITY_CASES[case]
    ref_root, ref_paths = _case_tree(tmp_path, "fia_tpu", files)
    port_root, port_paths = _case_tree(tmp_path, "fia_tpu_torch", files)
    ref = ref_core.lint_paths(ref_paths, root=str(ref_root),
                              select=PARITY_RULES)
    port = lint_paths(port_paths, root=str(port_root), select=PARITY_RULES)

    def key(res, pkg):
        return sorted((f.rule, f.path.replace(pkg, "{pkg}", 1), f.line,
                       f.col) for f in res.findings)

    assert key(port, "fia_tpu_torch") == key(ref, "fia_tpu")
    if want is None:
        assert port.ok
    else:
        assert want in _rules_hit(port)


# -- the port-local configuration -------------------------------------------

def _defs(rel: str) -> set[str]:
    """Qualified names of every def in a port module."""
    with open(os.path.join(REPO, rel)) as f:
        tree = ast.parse(f.read())
    out = set()

    def walk(node, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.add(prefix + child.name)
                walk(child, prefix + child.name + ".")
            elif isinstance(child, ast.ClassDef):
                walk(child, prefix + child.name + ".")
            else:
                walk(child, prefix)
    walk(tree, "")
    return out


CONFIG_ENTRIES = (
    [("capture", e[0], e[1]) for e in config.REGISTERED_CAPTURE_ENTRY_POINTS]
    + [("dispatch", p, n) for p, n in config.DISPATCH_PATH_FUNCTIONS]
    + [("sink", p, q) for p, q, _ in config.DETERMINISM_SINK_FUNCTIONS]
)


@pytest.mark.parametrize("kind,path,name", CONFIG_ENTRIES,
                         ids=[f"{k}:{p.split('/')[-1]}:{n}"
                              for k, p, n in CONFIG_ENTRIES])
def test_config_entry_resolves_to_a_port_def(kind, path, name):
    assert path.startswith("fia_tpu_torch/"), path
    defs = _defs(path)
    assert any(q == name or q.endswith("." + name) for q in defs), (
        f"{kind} entry {name!r} names no def of {path}")


def test_config_paths_are_the_ports_and_never_the_references():
    """Every module path of the port's config exists and lies in the
    port (or is a shared document or script), and no path of either
    config matches a file of the other package."""
    from fia_tpu.analysis import config as ref_config

    singles = [config.SITES_MODULE, config.METRICS_MODULE, config.OBS_MODULE,
               config.METRICS_CONSUMER, config.SITES_DOC,
               *config.RAW_WRITE_ALLOWED, *config.OBS_CONSUMERS,
               *config.WALLCLOCK_SEAM_FILES]
    for rel in singles:
        assert os.path.isfile(os.path.join(REPO, rel)), rel
        assert rel.startswith(("fia_tpu_torch/", "docs/", "scripts/")), rel
    port_files, ref_files = [], []
    for pkg, out in (("fia_tpu_torch", port_files), ("fia_tpu", ref_files)):
        for root, _, files in os.walk(os.path.join(REPO, pkg)):
            out += [os.path.relpath(os.path.join(root, f), REPO)
                    for f in files if f.endswith(".py")]
    for cfg, others in ((config, ref_files), (ref_config, port_files)):
        suffixes = list(cfg.RAW_WRITE_ALLOWED) + list(
            cfg.WALLCLOCK_SEAM_FILES) + [p for p, *_ in
                                         cfg.DISPATCH_PATH_FUNCTIONS]
        for rel in others:
            assert not rel.endswith(tuple(suffixes)), rel
            assert cfg.RELIABILITY_PREFIX not in rel, rel
            assert cfg.METRICS_SCOPE not in rel, rel
            assert not rel.startswith(cfg.OBS_PRINT_SCOPE), rel


def test_every_launch_wrapper_is_a_capture_scope():
    """The static half of chip_smoke 16a's binding: in each kernel module,
    the function that counts its kernel's launches is registered as a
    capture scope (16a adds that the card captured each such launch)."""
    from fia_tpu_torch.influence import kernels as K

    registered = {(e[0], e[1]) for e in config.REGISTERED_CAPTURE_ENTRY_POINTS}
    for mod in K.KERNEL_MODULES:
        rel = os.path.relpath(mod.__file__, REPO).replace(os.sep, "/")
        with open(mod.__file__) as f:
            tree = ast.parse(f.read())
        wrappers = {
            fn.name for fn in ast.walk(tree)
            if isinstance(fn, ast.FunctionDef) and any(
                isinstance(c, ast.Call)
                and getattr(c.func, "attr", None) == "count_launch"
                for c in ast.walk(fn))
        }
        assert wrappers, rel
        for name in wrappers:
            assert (rel, name) in registered, (rel, name)


def test_importing_the_linter_loads_no_torch():
    code = ("import sys\nimport fia_tpu_torch.analysis.lint\n"
            "import fia_tpu_torch.analysis.config\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'numpy', 'jax', 'fia_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True,
                         timeout=60)
    assert out.stdout.strip() == "[]", out.stdout
