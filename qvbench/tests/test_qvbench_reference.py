"""The comparison that decides `correct`, on a tiny cell on the CPU: the
port passes it, its control and each fault a served cell can have fail
it."""

from unittest import mock

import pytest

from conftest import TINY_CELL, make_root, narrow_config, tiny_config

SEED = 2**31 + 77


def _run(root, control=False, seconds=0.5, device="cpu"):
    from qvbench import run

    cell = run.load_cell(root, TINY_CELL)
    return run.run_cell(cell, SEED, seconds, False, device, control=control)


def test_the_port_passes_against_the_reference(tiny_root):
    res, lines = _run(tiny_root)
    assert res["correct"], lines
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "checks"
    assert [ln.split()[1] for ln in lines] == [
        "logit_gap", "kept_off_share", "length_mismatch"]


def test_a_number_without_a_limit_is_printed_not_compared(tmp_path):
    root = make_root(tmp_path, limits={"kept_off_share": 1e-3,
                                       "length_mismatch": 0})
    res, lines = _run(root)
    assert res["correct"], lines
    assert list(res["checks"]) == ["kept_off_share", "length_mismatch"]


def test_a_traced_run_reads_its_window(tiny_root):
    from qvbench import run

    cell = run.load_cell(tiny_root, TINY_CELL)
    res, _ = run.run_cell(cell, SEED, 0.5, True, "cpu")
    assert res["correct"]
    assert res["device"]["window_s"] > 0
    assert "kv_cache_mib" in res["metrics"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def _layer_left_unchanged():
    from quickvideo_tpu_torch.models.qwen25_vl import language

    inner = language.layer_step

    def step(lp, x, *args, **kw):
        out, idx = inner(lp, x, *args, **kw)
        return (x if args[3] == 1 else out), idx

    return [mock.patch.object(language, "layer_step", step)]


def _token_altered():
    from quickvideo_tpu_torch.models.qwen25_vl import language
    from quickvideo_tpu_torch.prefill import engine

    inner = language.compute_logits

    def logits(*args, **kw):
        return inner(*args, **kw).roll(1, -1)

    return [mock.patch.object(language, "compute_logits", logits),
            mock.patch.object(engine, "compute_logits", logits)]


@pytest.mark.parametrize("fault", [_layer_left_unchanged, _token_altered],
                         ids=["step-returns-its-state", "token-altered"])
def test_a_fault_in_the_timed_path_fails_the_check(tiny_root, fault):
    patches = fault()
    for p in patches:
        p.start()
    try:
        res, lines = _run(tiny_root)
    finally:
        for p in patches:
            p.stop()
    assert not res["correct"], lines


def test_int8_weights_pass_and_their_int4_control_fails(tmp_path):
    limits = {"logit_gap": 0.05, "kept_off_share": 0.05,
              "length_mismatch": 0}
    root = make_root(tmp_path, tiny_config(param_dtype="int8"), limits)
    res, lines = _run(root)
    assert res["correct"], lines
    ctl, ctl_lines = _run(root, control=True)
    assert not ctl["correct"], ctl_lines
    assert any(ctl["checks"][k]["value"] > 3 * res["checks"][k]["value"]
               for k in ("logit_gap", "kept_off_share"))


@pytest.mark.cuda
def test_the_port_on_the_card_passes_and_its_control_fails(card, tmp_path):
    """The narrow model with int8 weights through the port's kernels
    against the reference, then its int4 control."""
    limits = {"logit_gap": 0.05, "kept_off_share": 0.05,
              "length_mismatch": 0}
    root = make_root(tmp_path, narrow_config(), limits)
    res, lines = _run(root, device="cuda:0")
    assert res["correct"], lines
    ctl, ctl_lines = _run(root, control=True, device="cuda:0")
    assert not ctl["correct"], ctl_lines
