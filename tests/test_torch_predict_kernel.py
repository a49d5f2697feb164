"""The traversal kernel behind ``GBDT.predict_margin`` and its plain version.

On the CPU: ``predict_margin_ref`` (the port's plain loop) gives the JAX
package's margins on the same ensembles, bit for bit; the wrapper checks its
inputs and takes the plain version for CPU tensors without counting a
launch; the launch plan fits the card at every depth and width.  The
``cuda``-marked tests (``pytest -m cuda`` on a card) hold the kernel
bitwise equal to ``predict_margin_ref`` run on the card, and count one
launch a call.  The JAX package is imported inside the CPU tests only, so
the card's machine, which has no JAX, collects this file.
"""

import numpy as np
import pytest
import torch

from dmlc_core_tpu_torch import telemetry
from dmlc_core_tpu_torch.models.gbdt import GBDT, GBDTParam, TreeEnsemble
from dmlc_core_tpu_torch.ops import predict_cuda

# (name, K classes or None for a binary ensemble, handle_missing)
KINDS = [("binary", None, False), ("softmax3", 3, False),
         ("missing", None, True), ("softmax3_missing", 3, True)]
DEPTHS = [1, 8, 14]
BIN_DTYPES = [np.uint8, np.int32]


def _ensemble(trees, depth, features, num_bins, num_class, seed,
              no_split=0.2):
    """Random level-order trees: a share of nodes with ``split_feat = -1``,
    mixed ``default_left``, leaf values ~ N(0, 0.1), as numpy arrays in
    the ensemble's dtypes."""
    rng = np.random.RandomState(seed)
    lead = (trees,) if num_class is None else (trees, num_class)
    inner = 2 ** depth - 1
    sf = rng.randint(0, features, lead + (inner,)).astype(np.int32)
    sf[rng.rand(*sf.shape) < no_split] = -1
    sb = rng.randint(0, num_bins - 1, lead + (inner,)).astype(np.int32)
    lv = (0.1 * rng.randn(*lead, inner + 1)).astype(np.float32)
    dl = rng.rand(*lead, inner) < 0.5
    return sf, sb, lv, dl


def _bins(rows, features, num_bins, dtype, seed, missing=0.0):
    """Random bins; with ``missing`` that share of them is the missing bin
    (``num_bins - 1``)."""
    rng = np.random.RandomState(seed + 1)
    bins = rng.randint(0, num_bins, (rows, features))
    bins[rng.rand(rows, features) < missing] = num_bins - 1
    return bins.astype(dtype)


def _case(kind, depth, dtype, rows=300, features=5, trees=3, num_bins=16,
          seed=0):
    _, k, missing = next(c for c in KINDS if c[0] == kind)
    arrays = _ensemble(trees, depth, features, num_bins, k, seed)
    bins = _bins(rows, features, num_bins, dtype, seed,
                 missing=0.3 if missing else 0.0)
    miss_id = num_bins - 1 if missing else -1
    return arrays, bins, miss_id


def _jax_margin(arrays, bins, depth, num_bins, k, missing, base):
    from dmlc_core_tpu.models.gbdt import GBDT as JaxGBDT
    from dmlc_core_tpu.models.gbdt import GBDTParam as JaxParam
    from dmlc_core_tpu.models.gbdt import TreeEnsemble as JaxEnsemble

    kw = dict(max_depth=depth, num_bins=num_bins, handle_missing=missing,
              base_score=base)
    if k is not None:
        kw.update(objective="softmax", num_class=k)
    model = JaxGBDT(JaxParam(**kw), num_feature=bins.shape[1])
    return np.asarray(model.predict_margin(JaxEnsemble(*arrays), bins))


# -- CPU ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", BIN_DTYPES, ids=["uint8", "int32"])
@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("kind", [c[0] for c in KINDS])
def test_plain_version_is_the_jax_reference(kind, depth, dtype):
    arrays, bins, miss_id = _case(kind, depth, dtype, seed=depth)
    _, k, missing = next(c for c in KINDS if c[0] == kind)
    want = _jax_margin(arrays, bins, depth, 16, k, missing, base=0.25)
    got = predict_cuda.predict_margin_ref(
        *(torch.from_numpy(a) for a in arrays), torch.from_numpy(bins),
        depth, miss_id, 0.25)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", ["binary", "softmax3"])
def test_model_scores_cpu_tensors_with_the_plain_version(kind):
    """``GBDT.predict_margin`` on the CPU is the plain loop, launches
    nothing and marks its span ``method="ref"``."""
    arrays, bins, _ = _case(kind, 4, np.uint8, seed=7)
    k = 3 if kind == "softmax3" else 1
    param = GBDTParam(max_depth=4, num_bins=16, base_score=-0.5,
                      **({"objective": "softmax", "num_class": k}
                         if k > 1 else {}))
    model = GBDT(param, num_feature=bins.shape[1], device="cpu")
    predict_cuda.reset_launches()
    was = telemetry.enabled()
    telemetry.enable()
    telemetry.reset()
    try:
        got = model.predict_margin(TreeEnsemble(*arrays), bins)
        events = telemetry.get_tracer().events()
    finally:
        telemetry.reset()
        if not was:
            telemetry.disable()
    want = predict_cuda.predict_margin_ref(
        *(torch.from_numpy(a) for a in arrays), torch.from_numpy(bins), 4,
        -1, -0.5)
    assert torch.equal(got, want)
    assert [e["args"]["method"] for e in events] == ["ref"]
    assert predict_cuda.LAUNCHES == {"predict_margin_cuda": 0}


@pytest.mark.parametrize("features", [4, 6])
def test_model_refuses_bins_of_another_width(features):
    """``GBDT.predict_margin`` holds the bins' width to ``num_feature``
    before either path runs, so the kernel's left turn at a feature past
    the width can never answer a call the plain version would refuse."""
    arrays, bins, _ = _case("binary", 4, np.uint8, features=5, seed=3)
    model = GBDT(GBDTParam(max_depth=4, num_bins=16), num_feature=5,
                 device="cpu")
    wrong = _bins(50, features, 16, np.uint8, seed=3)
    with pytest.raises(RuntimeError, match=r"bins must be \[B, 5\]"):
        model.predict_margin(TreeEnsemble(*arrays), wrong)


def _torch_case(dtype=np.uint8, depth=3):
    arrays, bins, _ = _case("binary", depth, dtype)
    return [torch.from_numpy(a) for a in arrays], torch.from_numpy(bins)


@pytest.mark.parametrize("fault,match", [
    ("bins_int64", "uint8 or int32"),
    ("bins_transposed", "bins must be contiguous"),
    ("split_feat_int64", "split_feat must be torch.int32"),
    ("leaf_float64", "leaf_value must be torch.float32"),
    ("default_left_uint8", "default_left must be torch.bool"),
    ("split_bin_strided", "split_bin must be contiguous"),
    ("trees_elsewhere", "is on meta, bins on cpu"),
    ("depth_mismatch", "at max_depth 4"),
    ("depth_too_deep", "max_depth must be in"),
    ("miss_id", "miss_id must be in"),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(fault, match):
    trees, bins = _torch_case()
    depth, miss_id = 3, -1
    if fault == "bins_int64":
        bins = bins.long()
    elif fault == "bins_transposed":
        bins = bins.t().contiguous().t()
    elif fault == "split_feat_int64":
        trees[0] = trees[0].long()
    elif fault == "leaf_float64":
        trees[2] = trees[2].double()
    elif fault == "default_left_uint8":
        trees[3] = trees[3].to(torch.uint8)
    elif fault == "split_bin_strided":
        trees[1] = torch.cat([trees[1], trees[1]], dim=1)[:, ::2]
    elif fault == "trees_elsewhere":
        trees = [torch.empty_like(t, device="meta") for t in trees]
    elif fault == "depth_mismatch":
        depth = 4
    elif fault == "depth_too_deep":
        depth = 15
    elif fault == "miss_id":
        miss_id = 1024
    with pytest.raises(RuntimeError, match=match):
        predict_cuda.predict_margin_cuda(*trees, bins, depth, miss_id)


def test_wrapper_takes_the_plain_version_for_cpu_tensors():
    trees, bins = _torch_case(np.int32, depth=5)
    predict_cuda.reset_launches()
    got = predict_cuda.predict_margin_cuda(*trees, bins, 5, -1, 1.5)
    assert torch.equal(
        got, predict_cuda.predict_margin_ref(*trees, bins, 5, -1, 1.5))
    assert predict_cuda.LAUNCHES == {"predict_margin_cuda": 0}


@pytest.mark.parametrize("features", [1, 28, 67, 500, 2000,
                                      predict_cuda.MAX_FEATURE])
@pytest.mark.parametrize("depth", list(range(1, 15)))
def test_plan_fits_the_card(depth, features):
    """Every plan stays inside one block's shared memory, tiles whole
    chains where it can, and reads from global memory what does not fit."""
    plan = predict_cuda.predict_plan(features, depth, 500)
    record = 4 * 2 ** (depth + 1)
    bins = 4 * features * predict_cuda.ROWS
    assert plan.smem == (bins if plan.bins_smem else 0) \
        + 2 * plan.trees_per_tile * record
    assert plan.smem <= predict_cuda._SMEM_BYTES
    if plan.trees_per_tile >= predict_cuda.CHAINS:
        assert plan.trees_per_tile % predict_cuda.CHAINS == 0
    if plan.trees_per_tile == 0:
        # not even one record a buffer fits beside the bins, nor alone
        assert 2 * record > predict_cuda._TWO_BLOCK_SMEM
        assert bins + 2 * record > predict_cuda._SMEM_BYTES


def test_plan_of_the_score_cell():
    """HIGGS (28 uint8 features) at depth 8: bins and 12-tree tiles in
    shared memory, two blocks an SM; epsilon's 2,000 features read bins
    from global memory; depth 14's 128 KB records are read in place."""
    plan = predict_cuda.predict_plan(28, 8, 500)
    assert plan == predict_cuda.PredictPlan(True, 12, 28 * 2048 + 24 * 2048)
    assert plan.smem <= predict_cuda._TWO_BLOCK_SMEM
    eps = predict_cuda.predict_plan(2000, 8, 500)
    assert not eps.bins_smem and eps.trees_per_tile >= predict_cuda.CHAINS
    deep = predict_cuda.predict_plan(28, 14, 10)
    assert deep.bins_smem and deep.trees_per_tile == 0
    few = predict_cuda.predict_plan(28, 8, 3)
    assert few.trees_per_tile == 3


@pytest.mark.parametrize("features", [56, 67, 111])
def test_plan_stages_wide_bins_before_a_second_block(features):
    """Bins too wide for two blocks an SM are still staged, one block an
    SM, before the plan reads them from global memory with two."""
    plan = predict_cuda.predict_plan(features, 8, 500)
    two = predict_cuda.tier_plan(*predict_cuda.TIERS[2], features, 8, 500)
    assert plan.bins_smem and plan.trees_per_tile >= 1
    assert plan.smem > predict_cuda._TWO_BLOCK_SMEM
    assert not two.bins_smem and two.smem <= predict_cuda._TWO_BLOCK_SMEM
    assert plan == predict_cuda.tier_plan(*predict_cuda.TIERS[1], features,
                                          8, 500)


# -- the card -------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _on(card, arrays, bins):
    trees = [torch.from_numpy(a).to(card) for a in arrays]
    return trees, torch.from_numpy(bins).to(card)


def _kernel_and_plain(trees, bins, depth, miss_id, base):
    before = predict_cuda.LAUNCHES["predict_margin_cuda"]
    got = predict_cuda.predict_margin_cuda(*trees, bins, depth, miss_id, base)
    torch.cuda.synchronize()
    assert predict_cuda.LAUNCHES["predict_margin_cuda"] == before + 1
    want = predict_cuda.predict_margin_ref(*trees, bins, depth, miss_id, base)
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", BIN_DTYPES, ids=["uint8", "int32"])
@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("kind", [c[0] for c in KINDS])
def test_kernel_is_the_plain_version_bitwise(card, kind, depth, dtype):
    arrays, bins, miss_id = _case(kind, depth, dtype, rows=10_007,
                                  features=28, trees=9, num_bins=256,
                                  seed=depth)
    got, want = _kernel_and_plain(*_on(card, arrays, bins), depth, miss_id,
                                  0.25)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,features,num_bins,dtype,depth,trees", [
    (1, 28, 256, np.uint8, 8, 500),          # one row, the cell's model
    (63, 28, 256, np.uint8, 8, 37),
    (4_194_304, 28, 256, np.uint8, 8, 6),    # the cell's batch
    (20_011, 2000, 256, np.uint8, 8, 13),    # epsilon's width: bins global
    (20_011, 2000, 256, np.int32, 6, 5),
    (5_003, 27, 256, np.uint8, 8, 13),       # F % 4 != 0: bytewise staging
    (30_001, 28, 1024, np.int32, 10, 7),     # 1024 bins
    (3_001, 5, 1024, np.int32, 13, 3),       # one 64 KB record a tile
    (3_001, 67, 256, np.uint8, 8, 23),       # bins staged, one block an SM
    (2_003, 2000, 256, np.uint8, 14, 2),     # bins and trees read in place
])
def test_kernel_on_the_shapes_it_serves(card, rows, features, num_bins,
                                        dtype, depth, trees):
    arrays = _ensemble(trees, depth, features, num_bins, None, seed=rows)
    bins = _bins(rows, features, num_bins, dtype, seed=rows)
    got, want = _kernel_and_plain(*_on(card, arrays, bins), depth, -1, 0.0)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["missing", "softmax3_missing"])
def test_kernel_missing_bins_at_1024(card, kind):
    """handle_missing at 1024 bins: the missing bin is 1023, the top of
    what a node can hold."""
    arrays, bins, miss_id = _case(kind, 7, np.int32, rows=8_191,
                                  features=28, trees=11, num_bins=1024)
    assert miss_id == 1023
    got, want = _kernel_and_plain(*_on(card, arrays, bins), 7, miss_id, 0.0)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [None, 3])
def test_kernel_with_no_trees_returns_base_score(card, k):
    arrays = _ensemble(0, 8, 28, 256, k, seed=0)
    bins = _bins(100, 28, 256, np.uint8, seed=0)
    trees, b = _on(card, arrays, bins)
    got = predict_cuda.predict_margin_cuda(*trees, b, 8, -1, 0.75)
    want = predict_cuda.predict_margin_ref(*trees, b, 8, -1, 0.75)
    assert got.shape == want.shape == ((100,) if k is None else (100, 3))
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_kernel_rejects_a_cpu_cuda_mix(card):
    arrays, bins, _ = _case("binary", 3, np.uint8)
    trees, b = _on(card, arrays, bins)
    with pytest.raises(RuntimeError, match="is on cpu, bins on cuda"):
        predict_cuda.predict_margin_cuda(trees[0].cpu(), *trees[1:], b, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("features", [4, 6])
def test_kernel_path_refuses_bins_of_another_width(card, features):
    """On the card, as on the CPU, bins narrower or wider than the model's
    ``num_feature`` raise before any launch."""
    arrays, _, _ = _case("binary", 4, np.uint8, features=5, seed=3)
    model = GBDT(GBDTParam(max_depth=4, num_bins=16), num_feature=5,
                 device=card)
    ens = TreeEnsemble(*(torch.from_numpy(a).to(card) for a in arrays))
    wrong = torch.from_numpy(_bins(50, features, 16, np.uint8,
                                   seed=3)).to(card)
    before = predict_cuda.LAUNCHES["predict_margin_cuda"]
    with pytest.raises(RuntimeError, match=r"bins must be \[B, 5\]"):
        model.predict_margin(ens, wrong)
    assert predict_cuda.LAUNCHES["predict_margin_cuda"] == before


@pytest.mark.cuda
def test_model_scores_through_one_launch_a_call(card):
    """``GBDT.predict_margin`` on the card is one kernel call each time,
    with its span marked ``method="cuda"``, and gives the plain bits."""
    arrays, bins, _ = _case("binary", 8, np.uint8, rows=50_000, features=28,
                            trees=40, num_bins=256)
    model = GBDT(GBDTParam(max_depth=8, num_bins=256, base_score=0.5),
                 num_feature=28, device=card)
    ens = TreeEnsemble(*(torch.from_numpy(a).to(card) for a in arrays))
    b = torch.from_numpy(bins).to(card)
    was = telemetry.enabled()
    telemetry.enable()
    telemetry.reset()
    try:
        for call in range(3):
            before = predict_cuda.LAUNCHES["predict_margin_cuda"]
            got = model.predict_margin(ens, b)
            assert predict_cuda.LAUNCHES["predict_margin_cuda"] \
                == before + 1, call
        events = telemetry.get_tracer().events()
    finally:
        telemetry.reset()
        if not was:
            telemetry.disable()
    assert [e["args"]["method"] for e in events] == ["cuda"] * 3
    want = predict_cuda.predict_margin_ref(*ens[:4], b, 8, -1, 0.5)
    assert torch.equal(got, want)
