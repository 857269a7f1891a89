"""Converters from the JAX reference's tracking structures to the port's,
for the parity tests: ``ChannelState`` (leaves [C] or [B, C]),
``TrackParams`` (``fetch_in_kernel`` included) and replica tables.  One
place, so that every parity test hands both packages the same state."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cusdr_tpu import get_config
from cusdr_tpu.signals.defs import get_signal
from cusdr_tpu.tracking import engine as jeng
from cusdr_tpu_torch import get_config as t_get_config
from cusdr_tpu_torch.signals.defs import get_signal as t_get_signal
from cusdr_tpu_torch.tracking import engine as teng


def torch_state(jstate) -> teng.ChannelState:
    """The port's ChannelState (CPU tensors) from the reference's, leaf by
    leaf, dtypes kept."""
    return teng.ChannelState(**{
        name: torch.from_numpy(np.array(getattr(jstate, name)))
        for name in teng.ChannelState._fields})


def torch_params(jparams) -> teng.TrackParams:
    """The port's TrackParams from the reference's: the fields both have,
    ``fetch_in_kernel`` among them."""
    return teng.TrackParams(**{
        f.name: getattr(jparams, f.name)
        for f in dataclasses.fields(teng.TrackParams)})


def torch_tables(ctabs, ptabs, has_pilot: bool):
    """Replica tables as the port's engine takes them: the pilot tables
    are None without a pilot bank (the reference keeps zeros)."""
    return (torch.from_numpy(np.array(ctabs)),
            torch.from_numpy(np.array(ptabs)) if has_pilot else None)


def assert_states_equal(jstate, tstate):
    for name in teng.ChannelState._fields:
        a = np.asarray(getattr(jstate, name))
        b = getattr(tstate, name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(a, b), name


CHANNELS = [(7, 8500.0, 500), (9, 6000.0, 77, 3), (21, 7500.0, 900, 74)]


@pytest.mark.parametrize("signal", ["gps_l1ca", "gps_l2c"])
def test_converted_state_is_the_ports_initial_state(signal):
    sig, tsig = get_signal(signal), t_get_signal(signal)
    dops = [c[1] - 7000.0 for c in CHANNELS]
    jst = jeng.init_channel_state(CHANNELS, sig.chip_rate_hz, dopplers=dops,
                                  carrier_freq_hz=sig.carrier_freq_hz)
    tst = teng.init_channel_state(CHANNELS, tsig.chip_rate_hz, "cpu",
                                  dopplers=dops,
                                  carrier_freq_hz=tsig.carrier_freq_hz)
    assert_states_equal(jst, tst)
    conv = torch_state(jst)
    for a, b in zip(conv, tst):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_converted_state_keeps_block_axis():
    sig = get_signal("gps_l1ca")
    jst = jeng.init_channel_state(CHANNELS, sig.chip_rate_hz)
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), jst, jst)
    conv = torch_state(stacked)
    assert conv.abs_sample.shape == (2, 3)
    assert conv.abs_sample.dtype == torch.int64
    assert conv.pilot_period.dtype == torch.int32
    assert conv.active.dtype == torch.bool
    assert_states_equal(stacked, conv)


@pytest.mark.parametrize("fetch", [True, False])
@pytest.mark.parametrize("signal,over", [
    ("gps_l1ca", {}), ("gal_e5a", {}), ("bds_b1c", dict(pilot_trk_flag=2))])
def test_converted_params_are_the_ports(signal, over, fetch):
    jp = dataclasses.replace(
        jeng.make_track_params(get_config(signal, **over),
                               get_signal(signal)), fetch_in_kernel=fetch)
    tp = teng.make_track_params(t_get_config(signal, **over),
                                t_get_signal(signal))
    conv = torch_params(jp)
    assert conv.fetch_in_kernel is fetch
    assert conv == dataclasses.replace(tp, fetch_in_kernel=fetch)
