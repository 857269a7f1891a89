"""The port's numpy copies of reference modules stay verbatim, and its
jax-free alias ``cusdr_tpu_torch.host`` serves the reference's own files.

``tracking.cno``, ``tracking.loop_filters``, ``tracking.qmboc`` and
``acquisition.resample`` are copied because their reference packages'
``__init__`` imports jax; a copy that drifts from its original would make
the two packages disagree."""

from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("rel", ["tracking/cno.py",
                                 "tracking/loop_filters.py",
                                 "tracking/qmboc.py",
                                 "acquisition/resample.py"])
def test_copy_equals_reference(rel):
    assert (ROOT / "cusdr_tpu_torch" / rel).read_bytes() == \
        (ROOT / "cusdr_tpu" / rel).read_bytes()


def test_alias_serves_reference_files():
    import cusdr_tpu.config
    import cusdr_tpu_torch.host.config as hc
    import cusdr_tpu_torch.host.signals.defs as hd
    assert Path(hc.__file__) == Path(cusdr_tpu.config.__file__)
    assert Path(hd.__file__) == ROOT / "cusdr_tpu" / "signals" / "defs.py"
    assert hc.get_config("gps_l1ca") == hc.get_config("gps_l1ca")
    assert hc.get_config("gps_l1ca").samples_per_code == 18000


def test_cuda_device_requires_a_card():
    """The port never falls back to the CPU: asking for CUDA without a
    card raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from cusdr_tpu_torch import get_config
    from cusdr_tpu_torch.receiver import Receiver
    with pytest.raises(RuntimeError, match="cuda"):
        Receiver(get_config("gps_l1ca"), "cuda")
