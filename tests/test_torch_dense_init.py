"""``models.layers.dense_init`` scales its float32 draw in place
(``w.mul_(std)``: a stacked leaf at full width holds one float32
temporary, not two) and gives the bits the out-of-place ``(std *
w).to(dtype)`` gave, for float32 and bfloat16, several ``std`` values
(the fan-in default among them) and stacked shapes."""
import pytest
import torch

from repro_torch.models.layers import dense_init

SHAPES = [(7,), (64, 96), (3, 48, 80), (4, 2, 33, 65)]
STDS = [None, 0.02, 1.0, 0.5 ** 0.5, 3e-3]


def _old(gen, shape, dtype, *, fan_in, std=None):
    """The expression ``dense_init`` had before: ``(std * w).to(dtype)``."""
    std = fan_in ** -0.5 if std is None else std
    w = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (std * w).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_init_bitwise_the_out_of_place_scale(dtype):
    for seed, shape in enumerate(SHAPES):
        for std in STDS:
            fan_in = shape[-2] if len(shape) > 1 else shape[0]
            got = dense_init(torch.Generator().manual_seed(seed), shape,
                             dtype, fan_in=fan_in, std=std)
            want = _old(torch.Generator().manual_seed(seed), shape, dtype,
                        fan_in=fan_in, std=std)
            assert got.dtype == dtype and got.shape == torch.Size(shape)
            assert torch.equal(got.view(torch.int16 if dtype ==
                                        torch.bfloat16 else torch.int32),
                               want.view(torch.int16 if dtype ==
                                         torch.bfloat16 else torch.int32))
