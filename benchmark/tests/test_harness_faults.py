"""A run with the timed path broken underneath comes out not correct: an
answer altered where it is produced, a changed set of kept elements, and
REM with its banks left out.  The sound program comes out correct."""

import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"), qualities=(0.0, 3.7, 6.1, 10.0),
                          check_requests=4)


def _run(root, workload, factory=harness.Program):
    return tiny.run(root, workload, seconds=1.5, program_factory=factory)


@pytest.mark.parametrize("workload", ["flagship.kodak_b1_finegrid", "rem.kodak_b1_finegrid"])
def test_sound_program_is_correct(root, workload):
    out = _run(root, workload)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 4
    assert list(out)[-1] == "checks"


def test_altered_reconstruction_is_not_correct(root):
    class Altered(harness.Program):
        def request(self, x, quality):
            r = super().request(x, quality)
            r["x_hat"] = r["x_hat"] * 0.98
            return r

    out = _run(root, "flagship.kodak_b1_finegrid", Altered)
    assert not out["correct"]
    assert out["checks"]["xhat_rel_l2"][0] > out["checks"]["xhat_rel_l2"][1]


def test_changed_kept_set_is_not_correct(root, monkeypatch):
    from progressivecodec_tpu_torch.models import progressive

    ranked = progressive.stacked_channel_mask

    def shifted(scale_stack, *, pr, **kw):  # keeps the top (q + 0.5) / 10 instead of q / 10
        return ranked(scale_stack, pr=pr + 0.5 if 0 < pr < 10 else pr, **kw)

    monkeypatch.setattr(progressive, "stacked_channel_mask", shifted)
    out = _run(root, "flagship.kodak_b1_finegrid")
    assert out["failed"] == 0  # the program agrees with itself
    assert not out["correct"]
    assert out["checks"]["bytes_gap"][0] > out["checks"]["bytes_gap"][1]


def test_rem_without_banks_is_not_correct(root, monkeypatch):
    from progressivecodec_tpu_torch.models.progressive import ChannelProgressiveWACNN
    from progressivecodec_tpu_torch.models.rem import PostRateProcessedNetwork

    monkeypatch.setattr(PostRateProcessedNetwork, "_refine_prog_params",
                        ChannelProgressiveWACNN._refine_prog_params)
    out = _run(root, "rem.kodak_b1_finegrid")
    assert out["failed"] == 0
    assert not out["correct"]


def test_failed_traced_request_is_not_correct(root):
    class FailsTraced(harness.Program):
        def request(self, x, quality):
            r = super().request(x, quality)
            if torch.autograd._profiler_enabled():  # only inside the traced sub-window
                r["ok"] = False
            return r

    out = tiny.run(root, "flagship.kodak_b1_finegrid", seconds=1.5, trace=True, program_factory=FailsTraced)
    assert out["failed"] == 2  # the mix's profiled_requests
    assert not out["correct"]
