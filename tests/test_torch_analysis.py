"""The port's analyzer (``dmlc_core_tpu_torch.analysis``) against the
reference package's, and as the port's own gate.

- every Python fixture of the reference's analyzer tests
  (``tests/test_analysis.py``, read with ``ast``, never imported) runs
  through both packages' ``analyze_source`` and must give the same
  findings of the copied per-file passes;
- every multi-module fixture of those tests, and one cross-module trip
  fixture per project pass, runs through both packages' ``ProjectGraph``
  and must give the same deadlock, escape, race and taint findings;
- the gate exits 0 on this repo, its baseline gives every entry a reason,
  the generated catalog tables match the committed ``CATALOG.md``, and
  the CLI keeps the reference's flags and exit codes;
- the analyzer imports and runs with ``torch`` unavailable.
"""

import ast
import json
import os
import re
import subprocess
import sys
import textwrap

import pytest

from dmlc_core_tpu.analysis import deadlock as jax_deadlock
from dmlc_core_tpu.analysis import escape as jax_escape
from dmlc_core_tpu.analysis import races as jax_races
from dmlc_core_tpu.analysis import wiretaint as jax_wiretaint
from dmlc_core_tpu.analysis.driver import FileContext as JaxContext
from dmlc_core_tpu.analysis.driver import analyze_source as jax_analyze
from dmlc_core_tpu.analysis.graph import ProjectGraph as JaxGraph
from dmlc_core_tpu_torch.analysis import baseline as baseline_mod
from dmlc_core_tpu_torch.analysis import contracts
from dmlc_core_tpu_torch.analysis import deadlock, escape, races, wiretaint
from dmlc_core_tpu_torch.analysis.driver import (ALL_RULES, RULES_BY_PASS,
                                                 FileContext, main,
                                                 render_rule_catalog)
from dmlc_core_tpu_torch.analysis.driver import analyze_source
from dmlc_core_tpu_torch.analysis.graph import ProjectGraph

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE_TESTS = os.path.join(REPO, "tests", "test_analysis.py")
CATALOG = os.path.join(REPO, "dmlc_core_tpu_torch", "analysis", "CATALOG.md")
BASELINE = os.path.join(REPO, "dmlc_core_tpu_torch", "analysis",
                        "baseline.json")

# rules whose passes were redesigned (or whose docs differ): no parity
REDESIGNED = ("purity-", "jaxbound-", "torchbound-", "contract-")
# the relpaths each fixture runs under: plain library code, the network
# layers (assert-in-protocol) and the shm transport (shm-no-pickle)
PLACES = ("_fixture.py", "tracker/_fixture.py", "data/parse_proc.py")


def _to_port(text):
    return re.sub(r"\bdmlc_core_tpu\b", "dmlc_core_tpu_torch", text)


def _to_reference(text):
    return text.replace("dmlc_core_tpu_torch", "dmlc_core_tpu")


def _reference_tree():
    with open(REFERENCE_TESTS, encoding="utf-8") as f:
        return ast.parse(f.read(), REFERENCE_TESTS)


def _python_fixtures():
    """Every multi-line string constant of the reference's tests that
    parses as Python (dedented), once each."""
    seen = {}
    for node in ast.walk(_reference_tree()):
        if not (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and "\n" in node.value):
            continue
        src = textwrap.dedent(node.value)
        try:
            ast.parse(src)
        except SyntaxError:
            continue
        seen.setdefault(src, node.lineno)
    return sorted(seen.items(), key=lambda kv: kv[1])


def _module_fixtures():
    """Every dict literal of the reference's tests that maps
    ``dmlc_core_tpu/`` paths to sources: the multi-module fixtures."""
    out = []
    for node in ast.walk(_reference_tree()):
        if not (isinstance(node, ast.Dict) and node.keys):
            continue
        keys = [k.value if isinstance(k, ast.Constant) else None
                for k in node.keys]
        vals = [v.value if isinstance(v, ast.Constant) else None
                for v in node.values]
        if all(isinstance(k, str) and k.startswith("dmlc_core_tpu/")
               for k in keys) and all(isinstance(v, str) for v in vals):
            out.append((node.lineno, dict(zip(keys, vals))))
    return sorted(out, key=lambda kv: kv[0])


def _comparable(findings, port):
    out = []
    for f in findings:
        if f.rule.startswith(REDESIGNED):
            continue
        row = (f.rule, f.path, f.lineno, f.symbol, f.message)
        out.append(tuple(_to_reference(x) if port and isinstance(x, str)
                         else x for x in row))
    return out


PYTHON_FIXTURES = _python_fixtures()


@pytest.mark.parametrize("src,lineno", PYTHON_FIXTURES,
                         ids=[f"L{n}" for _, n in PYTHON_FIXTURES])
def test_per_file_passes_match_the_reference(src, lineno):
    for place in PLACES:
        want = jax_analyze(src, f"dmlc_core_tpu/{place}")
        got = analyze_source(_to_port(src), f"dmlc_core_tpu_torch/{place}")
        assert _comparable(got, True) == _comparable(want, False), \
            (lineno, place)


def test_fixture_harvest_covers_every_copied_per_file_pass():
    """The harvested fixtures trip every rule of the copied per-file
    passes in the reference, so the parity above is not vacuous."""
    rules = set()
    for src, _ in PYTHON_FIXTURES:
        for place in PLACES:
            rules |= {f.rule for f in jax_analyze(src,
                                                  f"dmlc_core_tpu/{place}")}
    for name in ("lockset", "resources", "protocol", "transport"):
        for rule in RULES_BY_PASS[name]:
            assert rule in rules, rule
    assert len(PYTHON_FIXTURES) >= 150


# -- project passes -----------------------------------------------------------

def _project_findings(files, port):
    if port:
        graph = ProjectGraph(
            FileContext(_to_port(rel), src, ast.parse(src), True, False)
            for rel, src in ((r, _to_port(textwrap.dedent(s)))
                             for r, s in files.items()))
        mods = (deadlock, escape, races, wiretaint)
    else:
        graph = JaxGraph(
            JaxContext(rel, src, ast.parse(src), True, False)
            for rel, src in ((r, textwrap.dedent(s)) for r, s in files.items()))
        mods = (jax_deadlock, jax_escape, jax_races, jax_wiretaint)
    out = []
    for mod in mods:
        out += mod.run_project(graph)
    return sorted(_comparable(out, port))


MODULE_FIXTURES = _module_fixtures()


@pytest.mark.parametrize("files,lineno", [(f, n) for n, f in MODULE_FIXTURES],
                         ids=[f"L{n}" for n, _ in MODULE_FIXTURES])
def test_project_passes_match_the_reference(files, lineno):
    assert _project_findings(files, True) == _project_findings(files, False)


# one cross-module fixture per project pass that trips it
TRIPS = {
    "deadlock-lock-cycle": {
        "dmlc_core_tpu/pa.py": """
            import threading
            from dmlc_core_tpu import pb

            class A:
                def __init__(self):
                    self._la = threading.Lock()
                    self.bee = pb.B()

                def one(self):
                    with self._la:
                        self.bee.two()
        """,
        "dmlc_core_tpu/pb.py": """
            import threading
            from dmlc_core_tpu.pa import A

            class B:
                def __init__(self):
                    self._lb = threading.Lock()

                def two(self):
                    with self._lb:
                        pass

                def back(self, a: "A"):
                    with self._lb:
                        a.one()
        """,
    },
    "deadlock-blocking-under-lock": {
        "dmlc_core_tpu/qa.py": """
            import threading
            from dmlc_core_tpu import qb

            class Holder:
                def __init__(self):
                    self._lock = threading.Lock()

                def drain(self, q):
                    with self._lock:
                        qb.wait_for(q)
        """,
        "dmlc_core_tpu/qb.py": """
            def wait_for(q):
                return q.get()
        """,
    },
    "escape-leak-on-raise": {
        "dmlc_core_tpu/ea.py": """
            import socket
            from dmlc_core_tpu import eb

            def dial(addr):
                s = socket.create_connection(addr)
                eb.handshake(s)
                s.close()
        """,
        "dmlc_core_tpu/eb.py": """
            def handshake(s):
                s.sendall(b"hi")
        """,
    },
    "race-unlocked-shared-write": {
        "dmlc_core_tpu/ra.py": """
            import threading
            from dmlc_core_tpu.rb import Counter

            class Pump:
                def __init__(self):
                    self.counter = Counter()
                    self._t = threading.Thread(target=self._run, daemon=True)
                    self._t.start()

                def _run(self):
                    try:
                        self.counter.bump()
                    except Exception:
                        raise

                def reset(self):
                    self.counter.zero()
        """,
        "dmlc_core_tpu/rb.py": """
            class Counter:
                def __init__(self):
                    self.n = 0

                def bump(self):
                    self.n += 1

                def zero(self):
                    self.n = 0
        """,
    },
    "taint-unbounded-wire-int": {
        "dmlc_core_tpu/tracker/wa.py": """
            from dmlc_core_tpu.tracker import wb

            def serve(sock):
                n = sock.recvint()
                return wb.read_n(sock, n) + sock.recvall(n)
        """,
        "dmlc_core_tpu/tracker/wb.py": """
            def read_n(sock, n):
                return sock.recv(4)
        """,
    },
}


@pytest.mark.parametrize("rule", sorted(TRIPS))
def test_project_trip_fixture_trips_both_packages_alike(rule):
    got = _project_findings(TRIPS[rule], True)
    assert rule in {f[0] for f in got}, got
    assert got == _project_findings(TRIPS[rule], False)


# -- the gate on this repo ----------------------------------------------------

def test_port_gate_is_clean_under_its_baseline():
    """The acceptance gate itself: the port's analyzer exits 0 here."""
    proc = subprocess.run(
        [sys.executable, "-m", "dmlc_core_tpu_torch.analysis"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 new finding(s)" in proc.stdout
    assert " 0 stale" in proc.stdout


def test_baseline_gives_every_entry_a_reason():
    with open(BASELINE, encoding="utf-8") as f:
        data = json.load(f)
    assert data["tool"] == "dmlclint" and data["version"] == 1
    for key, why in data["findings"].items():
        assert "TODO" not in why and len(why.split()) >= 8, key
        path, rule, _ = key.split(":", 2)
        assert rule in ALL_RULES, key
        assert path.startswith("dmlc_core_tpu_torch/") or \
            path == "chip_smoke.py", key


def test_committed_catalog_matches_code():
    """The generated knob, span and rule tables reproduce from the code,
    line for line, inside the port's CATALOG.md."""
    from dmlc_core_tpu_torch.analysis.driver import _project_contexts

    graph = ProjectGraph(_project_contexts())
    with open(CATALOG, encoding="utf-8") as f:
        text = f.read()
    for table in (contracts.render_knob_catalog(graph),
                  contracts.render_span_catalog(graph),
                  render_rule_catalog()):
        for line in table.splitlines():
            assert line in text, f"catalog drifted: {line}"


def test_catalog_is_the_only_doc_and_documents_the_port_knobs():
    assert contracts.DOC_FILES == (
        "dmlc_core_tpu_torch/analysis/CATALOG.md",)
    docs = contracts.load_docs(REPO)
    inv = contracts.extract_docs(docs)
    for knob in ("DMLC_COLLECTIVE_TIMEOUT", "DMLC_DRYRUN_OUT"):
        assert inv.documents("knob", knob)
    # the reference's JAX-only rows are not the port's contract
    assert not inv.documents("knob", "DMLC_TPU_PALLAS_INTERPRET")


def test_every_rule_belongs_to_exactly_one_pass():
    owned = [r for rules in RULES_BY_PASS.values() for r in rules]
    assert sorted(owned) == sorted(set(ALL_RULES) - {"syntax"})
    assert not any(r.startswith("jaxbound-") for r in ALL_RULES)


# -- the CLI ------------------------------------------------------------------

def _write_pkg(tmp_path, body, names=("victim.py",)):
    pkg = tmp_path / "dmlc_core_tpu_torch"
    pkg.mkdir()
    for name in names:
        (pkg / name).write_text(textwrap.dedent(body))
    return str(pkg)


def test_cli_list_rules(capsys):
    assert main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rule in ALL_RULES:
        assert rule in out
    assert "torchbound-rebuilt-per-call" in out and "jaxbound" not in out


def test_cli_jobs_output_matches_serial(tmp_path, capsys):
    pkg = _write_pkg(tmp_path, "print('oops')\n", ("a.py", "b.py", "c.py"))
    bl = str(tmp_path / "baseline.json")
    rc_serial = main([pkg, "--baseline", bl])
    serial = capsys.readouterr().out
    rc_jobs = main([pkg, "--baseline", bl, "--jobs", "2"])
    parallel = capsys.readouterr().out
    assert rc_serial == rc_jobs == 1
    assert parallel == serial and serial.count("style-no-print") == 3


def test_cli_format_sarif(tmp_path, capsys):
    pkg = _write_pkg(tmp_path, "print('oops')\n")
    bl = str(tmp_path / "baseline.json")
    assert main([pkg, "--baseline", bl, "--format", "sarif"]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc["version"] == "2.1.0"
    [result] = doc["runs"][0]["results"]
    assert result["ruleId"] == "style-no-print"
    assert result["locations"][0]["physicalLocation"]["artifactLocation"][
        "uri"] == "dmlc_core_tpu_torch/victim.py"
    rules = {r["id"] for r in doc["runs"][0]["tool"]["driver"]["rules"]}
    assert {"purity-host-sync", "torchbound-wide-wire"} <= rules
    out_file = str(tmp_path / "findings.sarif")
    assert main([pkg, "--baseline", bl, "--format", "github",
                 "--output", out_file]) == 1
    capsys.readouterr()
    with open(out_file, encoding="utf-8") as f:
        assert [r["ruleId"] for r in json.load(f)["runs"][0]["results"]] \
            == ["style-no-print"]


def test_cli_format_github(tmp_path, capsys):
    pkg = _write_pkg(tmp_path, "print('oops')\n")
    bl = str(tmp_path / "baseline.json")
    assert main([pkg, "--baseline", bl, "--format", "github"]) == 1
    out = capsys.readouterr().out
    line = [x for x in out.splitlines() if x.startswith("::error")][0]
    assert "file=dmlc_core_tpu_torch/victim.py" in line
    assert "line=1" in line and "title=dmlclint style-no-print" in line


def test_cli_write_baseline_round_trip(tmp_path, capsys):
    pkg = _write_pkg(tmp_path, "print('oops')\n")
    bl = str(tmp_path / "baseline.json")
    assert main([pkg, "--baseline", bl]) == 1
    assert main([pkg, "--baseline", bl, "--write-baseline"]) == 0
    data = json.loads(open(bl, encoding="utf-8").read())
    [key] = data["findings"]
    assert key == "dmlc_core_tpu_torch/victim.py:style-no-print:<module>"
    assert "TODO" in data["findings"][key]
    data["findings"][key] = "reviewed: a script's output"
    with open(bl, "w", encoding="utf-8") as f:
        json.dump(data, f)
    assert main([pkg, "--baseline", bl]) == 0
    # a new finding on top still fails; a rewrite keeps the reason
    mod = tmp_path / "dmlc_core_tpu_torch" / "victim.py"
    mod.write_text(mod.read_text() + "def leak(p):\n    open(p, 'w')\n")
    assert main([pkg, "--baseline", bl]) == 1
    assert main([pkg, "--baseline", bl, "--write-baseline"]) == 0
    kept = baseline_mod.load(bl)
    assert kept[key] == "reviewed: a script's output" and len(kept) == 2
    capsys.readouterr()


def test_cli_missing_target_and_unknown_pass_exit_2(tmp_path, capsys):
    assert main([str(tmp_path / "no" / "such.py")]) == 2
    assert "no such file" in capsys.readouterr().err
    assert main(["--pass", "jaxbound"]) == 2
    assert "unknown pass" in capsys.readouterr().err


def test_cli_exempts_the_port_scripts_from_no_print(tmp_path):
    src = "print('report')\n"
    for rel, flagged in (("dmlc_core_tpu_torch/ops/x.py", True),
                         ("dmlc_core_tpu_torch/tools/hist_times.py", False),
                         ("dmlc_core_tpu_torch/examples/train_gbdt.py", False),
                         ("dmlc_core_tpu_torch/graft_entry.py", False),
                         ("dmlc_core_tpu_torch/serve/__main__.py", False)):
        rules = [f.rule for f in analyze_source(src, rel)]
        assert ("style-no-print" in rules) == flagged, rel


def test_analyzer_runs_without_torch():
    """Standard library only: with torch, jax and the reference package
    unavailable, the analyzer imports, lists its rules and analyzes."""
    code = textwrap.dedent("""
        import sys
        for name in ("torch", "jax", "dmlc_core_tpu"):
            sys.modules[name] = None
        from dmlc_core_tpu_torch.analysis import analyze_source, main
        assert main(["--list-rules"]) == 0
        found = analyze_source(
            "def f(x):\\n    for i in range(3):\\n        x.item()\\n",
            "dmlc_core_tpu_torch/ops/x.py")
        assert [f.rule for f in found] == ["purity-host-sync"], found
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("torch", "jax", "dmlc_core_tpu")
               and sys.modules[m] is not None]
        assert not bad, bad
        print("stdlib only")
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "stdlib only" in proc.stdout, \
        proc.stdout + proc.stderr


@pytest.mark.slow
def test_gate_jobs_run_matches_serial_on_the_repo():
    """A second full-tree run: ``--jobs 4`` on the repo prints what the
    serial gate prints."""
    runs = [subprocess.run(
        [sys.executable, "-m", "dmlc_core_tpu_torch.analysis"] + extra,
        cwd=REPO, capture_output=True, text=True, timeout=300)
        for extra in ([], ["--jobs", "4"])]
    assert runs[0].returncode == runs[1].returncode == 0
    assert runs[0].stdout == runs[1].stdout
