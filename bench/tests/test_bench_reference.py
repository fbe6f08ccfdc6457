"""The reference's own threefry and coordinate stream against the
program's generator, bit for bit (the program reproduces JAX's), and the
control's TF32 rounding."""
import torch

from bench import reference


def test_split_and_uniform_match_the_program():
    from repro_torch.utils import prng
    key = prng.PRNGKey(3_000_000_017)
    assert torch.equal(reference.split_keys(key, 5), prng.split(key, 5))
    keys = prng.split(key, 7)
    assert torch.equal(reference.split_keys(keys, 3), prng.split(keys, 3))
    assert torch.equal(reference.uniform01(keys, 1000),
                       prng.uniform(keys, (1000,)))


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12,
                      -(1.0 + 3 * 2 ** -12), 3.0])
    got = reference._tf32(x)
    want = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -10,
                         -(1.0 + 2 ** -10), 3.0])
    assert torch.equal(got, want)
    bits = got.view(torch.int32) & 0x1FFF
    assert not bits.any()
