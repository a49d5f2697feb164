"""The port analyzer's torch rules: ``purity`` redesigned for torch and
``torchbound``, the counterpart of the reference's ``jaxbound``.

Every rule has a fixture that trips it and a clean twin that must not.
Fixtures are analyzed under ``dmlc_core_tpu_torch/`` paths so the deep
passes run; ``ops/`` and ``models/`` paths are device layers, whose
loops are purity roots.
"""

import ast
import textwrap

import pytest

from dmlc_core_tpu_torch.analysis import purity, torchbound
from dmlc_core_tpu_torch.analysis.driver import FileContext, analyze_source
from dmlc_core_tpu_torch.analysis.graph import ProjectGraph

OPS = "dmlc_core_tpu_torch/ops/_fixture.py"
HOST = "dmlc_core_tpu_torch/io/_fixture.py"
BRIDGE = "dmlc_core_tpu_torch/bridge/_fixture.py"


def purity_findings(src, relpath=OPS):
    return [(f.rule, f.lineno) for f in analyze_source(
        textwrap.dedent(src), relpath, passes=["purity"])]


def purity_rules(src, relpath=OPS):
    return sorted(rule for rule, _ in purity_findings(src, relpath))


def bound_findings(files):
    graph = ProjectGraph(
        FileContext(rel, textwrap.dedent(src),
                    ast.parse(textwrap.dedent(src)), True, False)
        for rel, src in files.items())
    return [(f.rule, f.path, f.lineno, f.symbol)
            for f in torchbound.run_project(graph)]


# -- purity: roots -------------------------------------------------------------

LOOP_ITEM = """
    import torch

    def fit(x):
        total = 0.0
        for step in range(10):
            total += x.sum().item()
        return total
"""


def test_host_sync_in_a_device_layer_loop_trips():
    assert purity_findings(LOOP_ITEM) == [("purity-host-sync", 7)]


def test_same_loop_outside_the_device_layers_is_clean():
    assert purity_rules(LOOP_ITEM, HOST) == []


def test_sync_after_the_loop_is_clean():
    assert purity_rules("""
        import torch

        def fit(x):
            for step in range(10):
                x = x * 2
            return x.sum().item()
    """) == []


def test_module_level_loop_is_not_a_root():
    assert purity_rules("""
        import torch
        for step in range(3):
            torch.ones(2).sum().item()
    """) == []


def test_calls_from_a_loop_are_followed_within_the_module():
    src = """
        import torch

        def _score(t: torch.Tensor):
            return float(t.max())

        def fit(x):
            for step in range(10):
                _score(x)
    """
    assert purity_findings(src) == [("purity-host-sync", 5)]


def test_autograd_function_roots():
    src = """
        import numpy as np
        import torch

        class Gather(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                ctx.n = int(x.shape[0])
                return x.cpu()

            @staticmethod
            def backward(ctx, g):
                return np.asarray(g)
    """
    assert purity_rules(src, HOST) == ["purity-host-sync", "purity-np-call"]


def test_plain_class_forward_is_not_a_root():
    assert purity_rules("""
        import torch

        class Layer:
            def forward(self, x):
                return x.cpu()
    """, HOST) == []


@pytest.mark.parametrize("site", [
    "step = torch.compile(_step)",
    "step = torch.jit.script(_step)",
    "graphed = torch.cuda.make_graphed_callables((_step,), (x,))",
])
def test_compile_and_graph_wrappers_root_their_callable(site):
    src = f"""
        import torch

        def _step(x):
            return x.tolist()

        def build(x):
            {site}
            return x
    """
    assert purity_findings(src, HOST) == [("purity-host-sync", 5)]


def test_compile_decorator_and_graph_capture_are_roots():
    src = """
        import torch

        @torch.compile(mode="reduce-overhead")
        def step(x):
            return x.numpy()

        def capture(g, x):
            with torch.cuda.graph(g):
                y = x * 2
                torch.cuda.synchronize()
            return y
    """
    assert purity_findings(src, HOST) == [("purity-host-sync", 6),
                                          ("purity-host-sync", 11)]


def test_re_compile_is_not_a_compile_root():
    assert purity_rules("""
        import re

        def _pat(x):
            return x.tolist()

        PAT = re.compile(_pat)
    """, HOST) == []


# -- purity: what syncs --------------------------------------------------------

@pytest.mark.parametrize("call", [
    "x.item()", "x.tolist()", "x.cpu()", "x.numpy()", 'x.to("cpu")',
    "torch.cuda.synchronize()", "ev.synchronize()", "torch.nonzero(x)",
    "x.nonzero()", "torch.unique(x)", "x.masked_select(m)",
    "torch.bincount(x)", "torch.where(m)", "x.repeat_interleave(m)",
    "torch.equal(x, x)", "float(x.sum())", "int(torch.argmax(x))",
])
def test_host_syncs_in_a_loop_trip(call):
    src = f"""
        import torch

        def run(x: torch.Tensor, m, ev):
            for _ in range(4):
                {call}
    """
    assert purity_findings(src) == [("purity-host-sync", 6)]


@pytest.mark.parametrize("call", [
    "x.to(torch.float32)", "x.to(dev)", "torch.where(m, x, y)",
    "x.repeat_interleave(m, output_size=8)", "float(step)",
    "int(x.shape[0])", "np.unique(a)", "a.tolist()", "a.item()",
    "x.size(0)",
])
def test_card_side_calls_in_a_loop_are_clean(call):
    src = f"""
        import numpy as np
        import torch

        def run(x, m, y, dev):
            a = np.arange(4)
            for step in range(4):
                {call}
    """
    assert purity_rules(src) == []


def test_tensor_inference_follows_bindings_and_annotations():
    src = """
        import torch

        def run(t: torch.Tensor, n: int, other):
            g = torch.cumsum(t, 0)
            h = g[1:] * 2
            for _ in range(n):
                int(h)
                float(t)
                float(other)
                bool(n)
    """
    assert purity_findings(src) == [("purity-host-sync", 8),
                                    ("purity-host-sync", 9)]


def test_host_branch_on_a_synced_value_trips():
    src = """
        import torch

        def run(x):
            for _ in range(4):
                if x.max().item() > 0:
                    x = x - 1
    """
    assert purity_findings(src) == [("purity-host-branch", 6)]


def test_host_branch_on_an_implicit_bool_trips():
    src = """
        import torch

        def run(x):
            done = torch.zeros(1)
            while not (done > 0).all():
                done = done + 1
            for _ in range(3):
                if done.any():
                    break
    """
    assert sorted(purity_findings(src)) == [("purity-host-branch", 6),
                                            ("purity-host-branch", 9)]


def test_branch_on_host_values_is_clean():
    assert purity_rules("""
        import torch

        def run(x, n_levels: int, mask=None):
            for depth in range(n_levels):
                if depth > 0 and mask is not None:
                    x = x * mask
                if x.shape[0] > 4:
                    x = x[:4]
    """) == []


def test_np_call_on_a_tensor_trips_and_on_a_host_array_is_clean():
    src = """
        import numpy as np
        import torch

        def run(x):
            t = torch.ones(3)
            a = np.ones(3)
            for _ in range(2):
                np.sum(t)
                np.sum(a)
    """
    assert purity_findings(src) == [("purity-np-call", 9)]


def test_impure_and_telemetry_calls_trip_in_a_compiled_callable():
    src = """
        import time
        import torch
        from dmlc_core_tpu_torch import telemetry

        @torch.compile
        def step(x):
            start = time.perf_counter()
            telemetry.count("dmlc_steps_total")
            y = x * 2
            if telemetry.enabled():
                telemetry.observe("dmlc_step_seconds",
                                  time.perf_counter() - start)
            return y
    """
    # the enabled()-gated observe is deliberate metering, not a finding
    assert purity_findings(src, HOST) == [
        ("purity-impure-call", 8), ("purity-telemetry-call", 9),
        ("purity-impure-call", 13)]


def test_a_host_loop_may_time_and_count():
    src = """
        import time
        import torch
        from dmlc_core_tpu_torch import telemetry

        def fit(x):
            for _ in range(3):
                start = time.perf_counter()
                telemetry.count("dmlc_steps_total")
                x = x * 2
                telemetry.observe("dmlc_step_seconds",
                                  time.perf_counter() - start)
            return x
    """
    assert purity_rules(src) == []


def test_suppression_comment_silences_a_purity_finding():
    src = LOOP_ITEM.replace(
        "total += x.sum().item()",
        "total += x.sum().item()  # dmlclint: disable=purity-host-sync")
    assert purity_rules(src) == []


def test_hot_regions_cover_roots_and_reached_functions():
    src = textwrap.dedent("""
        import torch

        def _score(t):
            return t

        def fit(x):
            y = x + 1
            for step in range(10):
                _score(x)
            return y
    """)
    ctx = FileContext(OPS, src, ast.parse(src), True, False)
    spans = purity.hot_regions(ctx)
    assert ("loop", 10, 10) in spans        # the loop body
    assert ("loop", 5, 5) in spans          # _score, reached from it
    assert not any(a <= 8 <= b for _, a, b in spans)   # before the loop


# -- torchbound: unaccounted transfers ------------------------------------------

LOADER = """
    import torch

    def _accounted_place(inner, path):
        def place(batch):
            return inner(batch)
        return place

    class Feed:
        def __init__(self, dev):
            self.dev = dev

        def _place(self, batch):
            return batch.to(self.dev)

        def __iter__(self):
            {use}
"""


def test_copy_to_the_card_outside_the_wrapper_trips():
    src = LOADER.format(use="yield self._place(torch.zeros(2))")
    assert bound_findings({BRIDGE: src}) == [
        ("torchbound-unaccounted-transfer", BRIDGE, 14, "Feed._place")]


def test_copy_inside_the_wrapper_is_clean():
    src = LOADER.format(
        use='place = _accounted_place(self._place, "feed")\n'
            '            yield place(torch.zeros(2))')
    assert bound_findings({BRIDGE: src}) == []


def test_callable_object_passed_to_the_wrapper_is_accounted():
    src = """
        import torch

        def _accounted_place(inner, path):
            return inner

        class _Placer:
            def __init__(self, dev):
                self.dev = dev

            def __call__(self, batch):
                out = torch.empty(batch.shape, device=self.dev)
                out.copy_(batch, non_blocking=True)
                return out

        class Feed:
            def __init__(self, dev):
                self._placer = None
                self.dev = dev

            def placer(self):
                if self._placer is None:
                    self._placer = _Placer(self.dev)
                inner = self._placer
                return _accounted_place(inner, "feed")
    """
    assert bound_findings({BRIDGE: src}) == []
    unwrapped = src.replace('return _accounted_place(inner, "feed")',
                            "return inner")
    assert [f[0] for f in bound_findings({BRIDGE: unwrapped})] == [
        "torchbound-unaccounted-transfer"]


@pytest.mark.parametrize("call,hit", [
    ("x.to(dev)", True), ("x.to(device=dev)", True), ("x.cuda()", True),
    ("torch.as_tensor(a, device=dev)", True),
    ("torch.tensor(a, device='cuda')", True),
    ("out.copy_(x, non_blocking=True)", True),
    ('x.to("cpu")', False), ("x.to(torch.float32)", False),
    ("x.to(dtype=torch.int32)", False), ("x.to(x.dtype)", False),
    ("torch.as_tensor(a)", False), ("out.copy_(x)", False),
])
def test_what_counts_as_a_copy_to_the_card(call, hit):
    src = f"""
        import torch

        def stage(x, a, out, dev):
            return {call}
    """
    found = bound_findings({BRIDGE: src})
    assert bool(found) == hit, found


def test_transfers_outside_bridge_are_out_of_scope():
    src = """
        def stage(x, dev):
            return x.to(dev)
    """
    assert bound_findings({"dmlc_core_tpu_torch/models/_fixture.py": src}) \
        == []


# -- torchbound: wide wire -----------------------------------------------------

@pytest.mark.parametrize("widen", [
    "w = bins.float()", "w = bins.to(torch.float32)",
    "w = bins.astype(np.float32)",
    "w = torch.as_tensor(bins, dtype=torch.float32)",
])
def test_widened_binned_data_reaching_a_copy_trips(widen):
    src = f"""
        import numpy as np
        import torch

        def feed(binner, x, dev):
            bins = binner.transform(x)
            {widen}
            return w.to(dev)
    """
    assert [f[0] for f in bound_findings({BRIDGE: src})] == [
        "torchbound-unaccounted-transfer", "torchbound-wide-wire"]


def test_widen_and_copy_in_one_expression_trips():
    src = """
        import torch

        def _accounted_place(inner, path):
            return inner

        def feed(binner, x, dev):
            bins = binner.transform(x)
            return bins.float().to(dev)

        PLACE = _accounted_place(feed, "feed")
    """
    assert [f[0] for f in bound_findings({BRIDGE: src})] == [
        "torchbound-wide-wire"]


def test_narrow_wire_and_unbinned_widening_are_clean():
    src = """
        import torch

        def _accounted_place(inner, path):
            return inner

        def feed(binner, x, labels, dev):
            bins = binner.transform(x)
            y = labels.float()
            return bins.to(dev), y.to(dev)

        PLACE = _accounted_place(feed, "feed")
    """
    assert bound_findings({BRIDGE: src}) == []


# -- torchbound: rebuilt per call -----------------------------------------------

NL = "\n" + " " * 16      # a new line of the method bodies below


@pytest.mark.parametrize("body", [
    "return torch.compile(self.step)(x)",
    "fn = torch.jit.script(self.step)" + NL + "return fn(x)",
    "return load_library().dmlc_tile()",
])
def test_rebuilt_per_call_trips(body):
    src = f"""
        import torch
        from dmlc_core_tpu_torch.ops._build import load_library

        class Runtime:
            def predict(self, x):
                {body}
    """
    assert [f[0] for f in bound_findings({OPS: src})] == [
        "torchbound-rebuilt-per-call"]


@pytest.mark.parametrize("body", [
    "self.fn = torch.compile(self.step)" + NL + "return self.fn(x)",
    "return torch.compile(self.step)",
    "fn = torch.compile(self.step)" + NL + "self._cache[0] = fn" + NL
    + "return fn(x)",
])
def test_kept_compiled_callables_are_clean(body):
    src = f"""
        import torch

        class Runtime:
            def predict(self, x):
                {body}
    """
    assert bound_findings({OPS: src}) == []


def test_construction_time_compile_is_clean():
    src = """
        import functools
        import torch

        STEP = torch.compile(lambda x: x * 2)

        class Runtime:
            def __init__(self, step):
                self.fn = torch.compile(step)(0)

        @functools.lru_cache(maxsize=None)
        def scorer(step):
            return torch.jit.script(step)(0)
    """
    assert bound_findings({OPS: src}) == []


def test_cuda_graph_captured_per_call_trips_and_kept_is_clean():
    src = """
        import torch

        class Runtime:
            def predict(self, x):
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g):
                    y = x * 2
                g.replay()
                return y

            def warm(self, x):
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g):
                    self.y = x * 2
                self.graph = g
    """
    assert [f[:2] + (f[3],) for f in bound_findings({OPS: src})] == [
        ("torchbound-rebuilt-per-call", OPS, "Runtime.predict")]


def test_memoized_loader_is_clean():
    loader = """
        _lib = None

        def load_library():
            global _lib
            if _lib is None:
                _lib = object()
            return _lib
    """
    user = """
        from dmlc_core_tpu_torch.ops._build import load_library

        def launch():
            return load_library().dmlc_tile()
    """
    files = {"dmlc_core_tpu_torch/ops/_build.py": loader, OPS: user}
    assert bound_findings(files) == []
    files["dmlc_core_tpu_torch/ops/_build.py"] = loader.replace(
        "global _lib", "pass")
    assert [f[0] for f in bound_findings(files)] == [
        "torchbound-rebuilt-per-call"]
