"""Trained-weight migration E2E: the ACTUAL torch reference pipeline trains
a mini vanilla-BERT experiment (real `train_all`, reference
scripts/train_all.py:16-65), every stage checkpoint is imported into
autognothi, and the deterministic measurement reports
(faithfulness curves/AUC, cls_acc, masked-accuracy endpoints) are asserted
to match across frameworks on the identical dataset + tokenizer.

This complements tests/test_torch_ckpt_import.py (which only loads
random-weight torch files): here the weights are genuinely *trained* by the
reference implementation, so matching faithfulness numbers prove
cross-framework semantic parity end-to-end."""

import pathlib
import sys

import pytest

sys.path.insert(0, "/root")
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "playground"))

pytestmark = pytest.mark.skipif(
    not pathlib.Path("/root/reference").exists(),
    reason="torch reference not mounted",
)


def test_reference_trained_ckpts_measure_identically(tmp_path: pathlib.Path):
    import migrate_reference_run as mig
    import reference_run as ref

    ref.install_stubs()
    ref_exp = tmp_path / "ref_torch"
    ref.seed_experiment(ref_exp, ref.MINI_NET_PARAMS, (0, 2, 2))
    theirs = ref.run_pipeline(ref_exp, perf_reports=False)
    assert {"accuracy", "cls_acc", "faithfulness"} <= set(theirs)

    jax_exp = mig.clone_experiment(ref_exp, tmp_path / "ref_jax")
    ours = mig.measure_ours(jax_exp)

    rows = mig.diff_reports(theirs, ours)
    assert len(rows) > 60  # full curve grid compared, not a smoke subset
    worst = max(rows, key=lambda r: r[3])
    bad = [r for r in rows if r[3] > 5e-4]
    assert not bad, f"cross-framework divergence, worst={worst}"
    # the headline metric agrees tightly
    ins_auc = [r for r in rows if r[0] == "faithfulness.insertion.auc"]
    assert ins_auc and ins_auc[0][3] < 1e-5


def test_reference_trained_vit_ckpts_measure_identically(tmp_path: pathlib.Path):
    """Same cross-framework proof on the CV track: the reference trains a
    mini vanilla-ViT on a shared synthetic image set (its dataset resolver
    is pointed at the set both frameworks construct deterministically),
    and our measurement suite reproduces its reports from the imported
    checkpoints."""
    import migrate_reference_run as mig
    import reference_run as ref

    ref.install_stubs()
    ref.install_cv_dataset()
    ref_exp = tmp_path / "ref_torch_vit"
    ref.seed_vit_experiment(ref_exp, ref.MINI_VIT_NET_PARAMS, (0, 2, 2),
                            resolution=3)
    theirs = ref.run_pipeline(ref_exp, perf_reports=False)
    assert {"accuracy", "cls_acc", "faithfulness"} <= set(theirs)

    jax_exp = mig.clone_experiment(ref_exp, tmp_path / "ref_jax_vit")
    ours = mig.measure_ours_cv(jax_exp)

    rows = mig.diff_reports(theirs, ours)
    assert len(rows) > 30
    worst = max(rows, key=lambda r: r[3])
    bad = [r for r in rows if r[3] > 5e-4]
    assert not bad, f"cross-framework divergence, worst={worst}"
    ins_auc = [r for r in rows if r[0] == "faithfulness.insertion.auc"]
    assert ins_auc and ins_auc[0][3] < 1e-5


def test_reference_trained_ltt_ckpts_measure_identically(tmp_path: pathlib.Path):
    """Third migration track (VERDICT r2 item 9): the reference trains a
    mini LTT ViT — the flagship ladder-side-tuning architecture the bench
    headlines — through its real conv chain (vanilla classifier import ->
    ladder surgery -> progressive explainer), and our measurement suite
    reproduces its reports from the imported torch checkpoints.
    Import semantics under test: recipes/ltt_vit.py conversion rules vs
    /root/reference/recipes/ltt_vit.py:163-261."""
    import migrate_reference_run as mig
    import reference_run as ref

    ref.install_stubs()
    ref.install_cv_dataset()
    ref.install_ltt_vit_conv_fix()  # documented upstream rule-gap workaround
    ref_exp = tmp_path / "ref_torch_ltt"
    ref.seed_vit_experiment(ref_exp, ref.MINI_LTT_VIT_NET_PARAMS, (0, 2, 2),
                            resolution=3, kind="ltt_vit")
    theirs = ref.run_pipeline(ref_exp, perf_reports=False)
    assert {"accuracy", "cls_acc", "faithfulness"} <= set(theirs)

    jax_exp = mig.clone_experiment(ref_exp, tmp_path / "ref_jax_ltt")
    ours = mig.measure_ours_cv(jax_exp)

    rows = mig.diff_reports(theirs, ours)
    assert len(rows) > 30
    worst = max(rows, key=lambda r: r[3])
    bad = [r for r in rows if r[3] > 5e-4]
    assert not bad, f"cross-framework divergence, worst={worst}"
    ins_auc = [r for r in rows if r[0] == "faithfulness.insertion.auc"]
    assert ins_auc and ins_auc[0][3] < 1e-5
