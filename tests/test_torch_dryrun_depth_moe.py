"""The dry-run at full depth, the MoE cells: the composed record equals
``trace_cut`` of the same config in every field, exactly (the check of
``test_torch_dryrun_depth.py``, in a file of its own for its time):
arctic-480b ``train_4k`` one layer past the reference test's 2-layer cut,
kimi-k2 ``train_4k`` at 4 layers on (2, 2, 4) (its leading dense layer in
every cut), and kimi-k2's decode step one layer past its cuts (a MoE
decode step's peak settles at three MoE layers).
"""
import pytest

pytest.importorskip("torch")

from test_torch_dryrun_depth import check_composed  # noqa: E402

COMPOSED = [("arctic-480b", "train_4k", {"n_layers": 3}, False),
            ("kimi-k2-1t-a32b", "train_4k", {"n_layers": 4}, True),
            ("kimi-k2-1t-a32b", "decode_32k", {"n_layers": 6}, True)]


@pytest.mark.parametrize("arch,shape,ovr,multi_pod", COMPOSED)
def test_composed_moe_record_equals_the_trace(monkeypatch, arch, shape, ovr,
                                              multi_pod):
    check_composed(monkeypatch, arch, shape, ovr, multi_pod)
