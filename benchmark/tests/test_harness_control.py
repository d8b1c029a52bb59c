"""The control on the card at TINY: the reference computed with TF32 in the
program's place fails the comparison, the float32 reference passes it.  The
full-size control is `python3 -m benchmark.control` (see PERF.md)."""

import pytest

from benchmark import compare, control
from benchmark.tests import tiny


@pytest.mark.cuda
def test_tf32_control_fails(card, tmp_path):
    from benchmark import harness

    root = tiny.make_root(tmp_path, qualities=(0.0, 3.7, 10.0), check_requests=3)
    for wl in ("flagship.kodak_b1_finegrid", "rem.kodak_b1_finegrid"):
        _, _, conf, mix = harness.load_cell(root, wl)
        ref = harness.reference(root, conf)
        mix.update({"height": 256, "width": 384})
        for seed in (11, 12, 13):
            w = control.readings(ref, conf, mix, seed, card, ["fp32", "tf32"])
            assert compare.verdict(w["fp32"], compare.LIMITS), w["fp32"]
            assert not compare.verdict(w["tf32"], compare.LIMITS), w["tf32"]
