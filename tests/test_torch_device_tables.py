"""The port's cached device tables never hand a fake tensor to a real call.

``models/encdec.py`` ``_positions`` (whisper's sinusoidal table) and
``kernels/ff_layer/ops.py`` ``rope_freqs`` are cached per (shape, device)
so that a compiled step's capture reads a table its eager warm-up made.
The dry run traces the same functions under ``FakeTensorMode`` on the
same shapes and devices: a table made there must not be cached, or the
next real call reads a fake one (whisper-tiny's loss gradients came back
as ``FakeTensor``s after a whisper dry-run cell in the same process).
Each function is called under the dry run's fake mode first, then
outside it, and the real call must give a real tensor equal to the plain
table bit for bit; the other order gives a fake table under the fake
mode; real calls share one cached table.
"""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode, is_fake

from repro_torch.kernels.ff_layer.ops import rope_freqs
from repro_torch.models import encdec
from repro_torch.models import layers as L

S, D = 24, 16                   # whisper smoke widths are not needed: any
THETA, HALF = 10000.0, 8        # (shape, device) key shows the hazard


def _plain_positions():
    return L.sinusoidal_positions(S, D)


def _plain_freqs():
    return THETA ** (-torch.arange(HALF, dtype=torch.float32) / HALF)


CASES = {
    "positions": (lambda dev: encdec._positions(S, D, dev), _plain_positions,
                  encdec._positions),
    "rope_freqs": (lambda dev: rope_freqs(THETA, HALF, dev), _plain_freqs,
                   rope_freqs),
}


@pytest.fixture(autouse=True)
def _fresh_caches():
    for _, _, fn in CASES.values():
        fn.cache_clear()
    yield
    for _, _, fn in CASES.values():
        fn.cache_clear()


@pytest.mark.parametrize("name", sorted(CASES))
def test_a_table_made_under_the_dry_runs_fake_mode_never_reaches_a_real_call(
        name):
    call, plain, _ = CASES[name]
    dev = torch.device("cpu")
    with FakeTensorMode(allow_non_fake_inputs=True):   # launch/dryrun.py's
        fake = call(dev)
        assert is_fake(fake)
    real = call(dev)
    assert not is_fake(real)
    assert type(real) is torch.Tensor
    np.testing.assert_array_equal(real.numpy(), plain().numpy())
    assert call(dev) is real                 # real calls share one table


@pytest.mark.parametrize("name", sorted(CASES))
def test_a_cached_real_table_is_not_handed_to_a_traced_call(name):
    call, plain, fn = CASES[name]
    dev = torch.device("cpu")
    real = call(dev)
    with FakeTensorMode(allow_non_fake_inputs=True):
        fake = call(dev)
        assert is_fake(fake) and fake is not real
        assert tuple(fake.shape) == tuple(real.shape)
    assert fn.cache_info().currsize == 1     # the fake one was not kept
    np.testing.assert_array_equal(call(dev).numpy(), plain().numpy())
