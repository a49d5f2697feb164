"""The port's ``dryrun_multichip`` on the CPU.

``graft_entry.dryrun_multichip(n, device="cpu")`` starts ``n`` ranks
through the port's launcher (gloo) and runs the reference dryrun's
sections in each: the GBDT round on data x model (K4's plain version on
the CPU), the sparsity-aware and 3-class fits, the sparse logistic step,
the tensor-parallel MLP step, the hybrid mesh at 8 ranks (its margin
within 1e-5 of the flat mesh's), and ring and Ulysses attention with the
ring's q gradient against ``reference_attention``.  It raises on any
failed check; here its printed line is held to the reference's words (the
assertions of ``tests/test_multichip_dryrun.py``).  Each launch takes
about 10 s here, so both sizes run.
"""

import pytest

from dmlc_core_tpu_torch import graft_entry


@pytest.mark.parametrize("n", [4, 8])
def test_dryrun_multichip_on_the_cpu(n, capsys):
    summary = graft_entry.dryrun_multichip(n, device="cpu", timeout_s=120)
    out = capsys.readouterr().out
    assert f"dryrun_multichip OK on {n} devices" in out
    assert summary["line"] in out
    assert "mesh data=" + str(n // 2) + " x model=2" in out
    assert "Ulysses" in out
    assert "K4's plain version on the CPU" in out
    # no kernel runs on the CPU: the plain versions are the path there
    assert summary["k4_launches"] == 0
    if n >= 8:
        assert "hybrid mesh dcn_data=2 x ici_data=2 x model=2" in out
    else:
        assert "hybrid mesh skipped" in out


def test_dryrun_multichip_needs_a_card_unless_cpu_is_asked():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the dryrun would run on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        graft_entry.dryrun_multichip(4)
