"""The port's dry run (prealps_tpu_torch/dryrun.py, the counterpart of
``__graft_entry__.dryrun_multichip``) on the CPU: without a card the
default device raises before any rank starts, and the (n/2, 2) LORASC
mesh needs an even rank count of at least 4. Its six paths run on the
card (tests/test_torch_cuda.py, 8 ranks sharing one card; chip_smoke's
[sharded_dryrun] and [dlorasc_dryrun] run its rank functions), and their
builds are held to ``__graft_entry__``'s in tests/test_torch_anchors.py.
"""

import pytest
import torch

from prealps_tpu_torch.dryrun import dryrun_multichip

torch.set_num_threads(1)


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        dryrun_multichip(4)


@pytest.mark.parametrize("n_ranks", [2, 3, 5])
def test_rank_count_checked(n_ranks):
    with pytest.raises(ValueError, match="even number"):
        dryrun_multichip(n_ranks, device="cpu")
