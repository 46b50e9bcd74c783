"""The PyTorch port's random layers draw from explicit generators only.

The two frameworks' random streams cannot match, so these tests check the
port on its own: the same seed gives the same masks, the rates hold, eval
and rate 0 are the identity, and a training forward with no generator set
raises instead of reading PyTorch's global random state.
"""

import dataclasses

import pytest
import torch

from vivim_tpu_torch.nn.layers import (
    Dropout,
    DropPath,
    FastDropout,
    fast_keep_mask,
    init_weights,
    use_generator,
)
from vivim_tpu_torch.nn.vivim import ScaleDropout, Vivim, VivimConfig

torch.set_num_threads(1)


@pytest.mark.parametrize("make,rate,draws", [
    (lambda: Dropout(0.3), 0.3, 64 * 16 * 16 * 8),
    (lambda: Dropout(0.3, broadcast_dims=(1, 2)), 0.3, 64 * 8),
    (lambda: DropPath(0.25), 0.25, 64),
    (lambda: FastDropout(0.1), 1 - 230 / 256, 64 * 16 * 16 * 8),
])
def test_same_seed_same_mask_and_rate(make, rate, draws):
    """The dropped share is within 4 standard deviations of the rate."""
    x = torch.ones(64, 16, 16, 8)
    outs = []
    for _ in range(2):
        layer = make().train()
        layer.generator = torch.Generator().manual_seed(3)
        outs.append(layer(x))
    assert torch.equal(outs[0], outs[1])
    dropped = float((outs[0] == 0).float().mean())
    assert abs(dropped - rate) < 4 * (rate * (1 - rate) / draws) ** 0.5, \
        dropped
    kept = outs[0][outs[0] != 0]
    torch.testing.assert_close(kept, torch.full_like(kept, 1 / (1 - rate)))
    layer.generator = torch.Generator().manual_seed(4)
    assert not torch.equal(layer(x), outs[0])
    assert torch.equal(layer.eval()(x), x)


def test_dropout2d_drops_whole_channels():
    layer = Dropout(0.5, broadcast_dims=(1, 2)).train()
    layer.generator = torch.Generator().manual_seed(0)
    y = layer(torch.ones(4, 6, 6, 32))
    per_channel = y.reshape(4, 36, 32)
    assert torch.equal(per_channel.amin(1), per_channel.amax(1))


def test_scale_dropout_gates_half_the_scales():
    layer = ScaleDropout(0.15).train()
    layer.generator = torch.Generator().manual_seed(1)
    x = torch.ones(2, 8, 8, 16)
    dropped = [bool((layer(x) == 0).any()) for _ in range(400)]
    assert 0.4 < sum(dropped) / 400 < 0.6


def test_fast_keep_mask_quantizes_keep():
    gen = torch.Generator().manual_seed(0)
    mask, keep = fast_keep_mask(gen, 0.7, (200000,), "cpu")
    assert keep == round(0.7 * 256) / 256
    assert abs(float(mask.float().mean()) - keep) < 0.005
    assert fast_keep_mask(gen, 0.9999, (5,), "cpu")[1] == 1.0


def test_model_training_needs_a_generator_and_is_reproducible():
    """A train-mode Vivim forward with dropout on raises until the caller
    hands it a generator; the same seed then gives the same logits and
    never touches the global random state."""
    cfg = VivimConfig.micro_test()
    cfg = dataclasses.replace(cfg, segformer=dataclasses.replace(
        cfg.segformer, drop_path_rate=0.3))
    model = init_weights(Vivim(cfg), torch.Generator().manual_seed(0))
    clip = torch.randn(1, 2, 32, 32, 3, generator=torch.Generator()
                       .manual_seed(1))
    model.train()
    with pytest.raises(RuntimeError, match="explicit generator"):
        model(clip)
    outs = []
    for _ in range(2):
        use_generator(model, torch.Generator().manual_seed(5))
        state = torch.random.get_rng_state()
        with torch.no_grad():
            outs.append(model(clip))
        assert torch.equal(torch.random.get_rng_state(), state)
    assert torch.equal(outs[0], outs[1])
