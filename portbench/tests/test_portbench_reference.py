"""The reference against the port on the CPU at tiny sizes.

The reference never imports the port; these tests do, to show that the two
agree where they should: the same Threefry bits and draws, the same
routing and scores, and, with the exact ``"scatter"`` histogram, the same
trees.  They also show that the comparison calls the port's own trees
sound and its lower-precision control unsound.
"""

import numpy as np
import pytest
import torch

from dmlc_core_tpu_torch.models import gbdt as port
from dmlc_core_tpu_torch.ops import hist_cuda
from dmlc_core_tpu_torch.utils import threefry as port_threefry
from portbench import data
from portbench.reference import check, gbdt, threefry

DATA = {"latent_factors": 4, "feature_noise": 1.0, "label_linear": 3,
        "label_pairs": 2, "label_noise": 0.5}
PARAMS = {"objective": "logistic", "max_depth": 4, "learning_rate": 0.3,
          "num_bins": 32}


def _rows(n=4000, f=6, seed=7):
    return data.make_rows(DATA, n, f, PARAMS["num_bins"], seed, "cpu")


@pytest.mark.parametrize("seed", [0, 5, 2 ** 31 + 11])
def test_threefry_copy_is_the_ports(seed):
    key = threefry.fold_in(threefry.prng_key(seed), 3)
    assert key == port_threefry.fold_in(port_threefry.prng_key(seed), 3)
    assert torch.equal(threefry.uniform(key, (1000,)),
                       port_threefry.uniform(key, (1000,)))


@pytest.mark.parametrize("rnd", [0, 4])
def test_draws_are_the_ports(rnd):
    p = dict(PARAMS, seed=123, subsample=0.8, colsample_bytree=0.7,
             colsample_bylevel=0.6)
    param = port.GBDTParam(**p)
    row_w, tree_mask = gbdt.tree_draws(p, rnd, 500, 9, "cpu")
    pw, pm = port._tree_sampling(param, rnd, 500, 9, device="cpu")
    assert torch.equal(row_w, pw) and torch.equal(tree_mask, pm)
    port_level = port._level_mask_fn(param, rnd, 9, "cpu")
    for d in range(PARAMS["max_depth"]):
        mine = gbdt.level_mask(p, rnd, d, 9, tree_mask, "cpu")
        assert torch.equal(mine, port_level(d, 1, pm)[0])


def test_histogram_is_the_ports_segment_sum():
    bins, _ = _rows()
    gen = torch.Generator().manual_seed(1)
    node = torch.randint(0, 4, (bins.shape[0],), generator=gen)
    g = torch.randn(bins.shape[0], generator=gen)
    h = torch.rand(bins.shape[0], generator=gen)
    G, H = gbdt.histogram(bins, node, g.double(), h.double(), 4,
                          PARAMS["num_bins"])
    pg, ph = hist_cuda.scatter_sums(bins, node.to(torch.int32), g, h, 4,
                                    PARAMS["num_bins"])
    assert torch.allclose(G, pg.double(), atol=1e-4)
    assert torch.allclose(H, ph.double(), atol=1e-4)


def test_histogram_blocks_agree(monkeypatch):
    bins, _ = _rows(n=3001, f=7)
    node = torch.arange(bins.shape[0]) % 2
    g = torch.linspace(-1, 1, bins.shape[0], dtype=torch.float64)
    whole = gbdt.histogram(bins, node, g, g.abs(), 2, PARAMS["num_bins"])
    monkeypatch.setattr(gbdt, "_BLOCK", 1000)
    blocked = gbdt.histogram(bins, node, g, g.abs(), 2, PARAMS["num_bins"])
    for a, b in zip(whole, blocked):
        assert torch.allclose(a, b, rtol=1e-12, atol=1e-12)


def test_trees_are_the_ports_scatter_fit():
    bins, label = _rows()
    p = dict(PARAMS, num_boost_round=3, hist_method="scatter")
    model = port.GBDT(port.GBDTParam(**p), num_feature=bins.shape[1],
                      device="cpu")
    ens, margin = model.fit_binned(bins, label)
    ref_margin = torch.zeros(bins.shape[0])
    for t in range(3):
        sf, sb, lv, ref_margin = gbdt.build_tree(bins, ref_margin, label,
                                                 PARAMS, t, None, None)
        assert torch.equal(sf, ens.split_feat[t])
        assert torch.equal(sb[sf >= 0], ens.split_bin[t][sf >= 0])
        assert torch.allclose(lv, ens.leaf_value[t], rtol=1e-5, atol=1e-6)
    assert torch.allclose(ref_margin, margin, atol=1e-5)


def test_routing_and_scores_are_the_ports():
    bins, _ = _rows(n=2000)
    trees = data.make_ensemble(5, PARAMS["max_depth"], bins.shape[1],
                               PARAMS["num_bins"], 0.1, 3, "cpu")
    for t in range(5):
        assert torch.equal(
            gbdt.leaves(bins, trees[0][t], trees[1][t], PARAMS["max_depth"]),
            port._route_tree(trees[0][t], trees[1][t], trees[3][t],
                             bins.to(torch.int32), PARAMS["max_depth"]))
    model = port.GBDT(port.GBDTParam(**PARAMS), num_feature=bins.shape[1],
                      device="cpu")
    got = model.predict(port.TreeEnsemble(*trees), bins)
    assert check.judge_score(bins, trees, got,
                             PARAMS["max_depth"])["score_err"] < 1e-6


def test_judge_holds_the_ports_kernel_path_and_fails_its_control():
    bins, label = _rows()
    p = dict(PARAMS, num_boost_round=4, hist_method="pallas")
    model = port.GBDT(port.GBDTParam(**p), num_feature=bins.shape[1],
                      device="cpu")
    ens, margin = model.fit_binned(bins, label)
    sound = check.judge_train(bins, label, tuple(ens[:4]), margin, PARAMS,
                              4, [0, 2], "bfloat16")
    assert sound["shape_faults"] == 0 and sound["margin_err"] == 0
    assert sound["split_gap"] < 1e-6 and sound["leaf_err_med"] < 1e-5
    margin = torch.zeros(bins.shape[0])
    trees = []
    for t in range(4):
        sf, sb, lv, margin = gbdt.build_tree(bins, margin, label, PARAMS, t,
                                             "float8_e4m3fn", "tfloat32")
        trees.append((sf, sb, lv, torch.zeros_like(sf, dtype=torch.bool)))
    low = tuple(torch.stack([tr[i] for tr in trees]) for i in range(4))
    control = check.judge_train(bins, label, low, margin, PARAMS, 4,
                                [0, 2], "bfloat16")
    assert control["leaf_err_med"] > 30 * max(sound["leaf_err_med"], 1e-7)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -(1.0 + 2 ** -12)], dtype=torch.float32)
    got = gbdt.rounded(x, "tfloat32")
    want = torch.tensor([1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9, -1.0],
                        dtype=torch.float64)
    assert torch.equal(got, want)


def test_unsupported_parameters_are_refused():
    with pytest.raises(ValueError):
        gbdt.check_supported(dict(PARAMS, handle_missing=True))
    gbdt.check_supported(dict(PARAMS, subsample=0.5))


def test_rows_are_balanced_and_binned_evenly():
    bins, label = _rows(n=20000, f=3)
    assert abs(float(label.mean()) - 0.5) < 0.01
    counts = np.bincount(bins[:, 0].numpy(), minlength=PARAMS["num_bins"])
    assert counts.min() > 0.8 * counts.mean()
    again, again_label = _rows(n=20000, f=3)
    assert torch.equal(bins, again) and torch.equal(label, again_label)
