"""A run whose timed path is broken underneath comes out not correct, once
for each fault a cell can have, and so does the control: the reference in
the program's place one precision step below the configuration.  On the
CPU, in a throwaway checkout, through the harness's own ``main`` with only
its look for a card skipped.  (No cell spans chips, so no exchange between
chips can be left out.)"""

import json

import pytest

from portbench.tests import tiny

GBDT = "from dmlc_core_tpu_torch.models import gbdt as G\n"

TRAIN_FAULTS = {
    # a window call that returns the job's state unchanged
    "state_unchanged": GBDT + """
real = G.GBDT.append_rounds
def unchanged(self, ens, bins, label, weight=None, *, num_rounds=1,
              margin=None, start_round=None):
    if num_rounds > 1:
        return ens, margin
    return real(self, ens, bins, label, weight, num_rounds=num_rounds,
                margin=margin, start_round=start_round)
G.GBDT.append_rounds = unchanged
""",
    # histograms over half the rows, doubled: the mean taken over the rest
    "half_rows": GBDT + """
real = G.grad_histogram
def half(bins, node, g, h, *a, **k):
    keep = (G.torch.arange(g.shape[0]) < g.shape[0] // 2).float() * 2
    return real(bins, node, g * keep, h * keep, *a, **k)
G.grad_histogram = half
""",
    # a leaf value altered where the tree is grown
    "leaf_altered": GBDT + """
real = G._build_tree
def altered(*a, **k):
    out = list(real(*a, **k))
    out[2] = out[2].clone()
    out[2][0] += 0.01
    return tuple(out)
G._build_tree = altered
""",
}

SCORE_FAULTS = {
    # every call hands back the scores of the call before
    "state_unchanged": GBDT + """
real = G.GBDT.predict
last = []
def stale(self, ens, bins):
    out = real(self, ens, bins)
    last.append(out)
    return last[-2] if len(last) > 1 else out
G.GBDT.predict = stale
""",
    # half the batch left out, filled with the mean of the rest
    "half_rows": GBDT + """
real = G.GBDT.predict
def half(self, ens, bins):
    n = bins.shape[0] // 2
    out = real(self, ens, bins[:n])
    return G.torch.cat([out, out.mean().expand(bins.shape[0] - n)])
G.GBDT.predict = half
""",
    # one score altered where it is produced
    "score_altered": GBDT + """
real = G.GBDT.predict
def altered(self, ens, bins):
    out = real(self, ens, bins).clone()
    out[3] += 0.01
    return out
G.GBDT.predict = altered
""",
}


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return tiny.checkout(tmp_path_factory.mktemp("faults"))


def _result(rc, out, err):
    assert rc == 0, err
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", ["tiny.train", "tiny.train_sampled"])
@pytest.mark.parametrize("fault", sorted(TRAIN_FAULTS))
def test_train_fault_is_not_correct(checkout, cell, fault):
    res = _result(*tiny.run(checkout, cell, plant=TRAIN_FAULTS[fault]))
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("fault", sorted(SCORE_FAULTS))
def test_score_fault_is_not_correct(checkout, fault):
    res = _result(*tiny.run(checkout, "tiny.score",
                            plant=SCORE_FAULTS[fault]))
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_is_not_correct(checkout, cell, seed):
    rc, out, err = tiny.run(checkout, cell, seed=seed, entry="control")
    assert rc == 0, err
    line = json.loads(out.strip().splitlines()[-1])
    assert line["control_correct"] is False, line["checks"]
