"""PyTorch port vs the JAX package: logging and the ``CHECK`` family.

The cases of ``tests/test_logging.py`` run on the port's
``utils/logging.py``, and the lines both packages hand their sinks must
agree (severity, caller file:line, text), as must the ``Check failed``
messages and the severity filter.
"""

import re

import pytest

from dmlc_core_tpu.utils import logging as J
from dmlc_core_tpu_torch.utils import logging as L

BOTH = {"jax": J, "port": L}


@pytest.fixture
def sinks():
    """Capture each package's sink as (severity, line) pairs."""
    got = {"jax": [], "port": []}
    for name, mod in BOTH.items():
        mod.set_log_sink(lambda sev, line, out=got[name]: out.append(
            (sev, line)))
    yield got
    for mod in BOTH.values():
        mod.set_log_sink(None)
        mod.set_min_severity(mod.INFO)


def _strip_stamp(line):
    return re.sub(r"^\[\d\d:\d\d:\d\d\] ", "", line)


def test_check_pass_and_fail():
    L.CHECK(True)
    L.CHECK_EQ(1, 1)
    L.CHECK_NE(1, 2)
    L.CHECK_LT(1, 2)
    L.CHECK_GT(2, 1)
    L.CHECK_LE(1, 1)
    L.CHECK_GE(1, 1)
    with pytest.raises(L.Error, match="Check failed"):
        L.CHECK(False, "boom")
    with pytest.raises(L.Error, match="=="):
        L.CHECK_EQ(1, 2)
    with pytest.raises(L.Error):
        L.CHECK_NOTNULL(None)
    assert L.CHECK_NOTNULL(5) == 5


@pytest.mark.parametrize("name,args", [
    ("CHECK", (0, "boom")), ("CHECK_EQ", (1, 2)), ("CHECK_NE", (3, 3)),
    ("CHECK_LT", (2, 1)), ("CHECK_GT", (1, 2)), ("CHECK_LE", (2, 1)),
    ("CHECK_GE", (1, 2, "why")), ("CHECK_NOTNULL", (None,)),
])
def test_check_messages_match(sinks, name, args):
    msgs = {}
    for pkg, mod in BOTH.items():
        with pytest.raises(mod.Error) as err:
            getattr(mod, name)(*args)
        # "[file:line] Check failed: ...": the caller is this test file
        where, text = str(err.value).split("] ", 1)
        assert where.startswith("[test_torch_logging.py:")
        msgs[pkg] = text
        # the failure is logged at FATAL through the sink first
        assert sinks[pkg][-1][0] == mod.FATAL
        assert text in sinks[pkg][-1][1]
    assert msgs["jax"] == msgs["port"]


def test_fatal_raises_with_stack():
    with pytest.raises(L.Error, match="Stack trace"):
        L.LOG(L.FATAL, "fatal message")
    with pytest.raises(L.Error, match="fatal too"):
        L.log_fatal("fatal too")


def test_sink_redirect_matches(sinks):
    for mod in BOTH.values():
        mod.log_info("hello sink")
        mod.log_warning("warn sink")
        mod.log_error("error sink")
        mod.LOG(mod.WARNING, "via LOG")
    j = [(s, _strip_stamp(x).split(": ", 1)[1]) for s, x in sinks["jax"]]
    p = [(s, _strip_stamp(x).split(": ", 1)[1]) for s, x in sinks["port"]]
    assert j == p == [("INFO", "hello sink"), ("WARNING", "warn sink"),
                      ("ERROR", "error sink"), ("WARNING", "via LOG")]
    # file:line of the caller is embedded
    assert all("test_torch_logging.py:" in x for _, x in sinks["port"])


def test_stream_style_message(sinks):
    msg = L.LogMessage(L.INFO)
    msg << "x=" << 42
    msg.flush()
    assert "x=42" in sinks["port"][0][1]
    # emitted on deletion when not flushed
    tail = L.LogMessage(L.WARNING)
    tail << "late"
    del tail
    assert sinks["port"][1][0] == L.WARNING and "late" in sinks["port"][1][1]
    with pytest.raises(L.Error, match="bad"):
        fatal = L.LogMessage(L.FATAL)
        fatal << "bad"
        fatal.flush()


def test_log_debug_gated(sinks, monkeypatch):
    monkeypatch.setenv("DMLC_LOG_DEBUG", "0")
    L.log_debug(1, "hidden")
    monkeypatch.setenv("DMLC_LOG_DEBUG", "2")
    L.log_debug(1, "shown")
    assert len(sinks["port"]) == 1 and "shown" in sinks["port"][0][1]


def test_min_severity_filters_stderr(capsys):
    for mod in BOTH.values():
        mod.set_min_severity(mod.WARNING)
        try:
            mod.log_info("quiet info")
            mod.log_warning("loud warning")
        finally:
            mod.set_min_severity(mod.INFO)
    err = capsys.readouterr().err.splitlines()
    assert [e[0] for e in err] == ["W", "W"]
    assert all("loud warning" in e for e in err)
    for mod in BOTH.values():
        with pytest.raises(ValueError, match="unknown severity"):
            mod.set_min_severity("LOUD")
