"""The device exactness checks that chip_smoke.py runs at deployment
widths on the GPU (kvazaar_jax.devcheck), here at tiny widths on the
CPU, plus the einsum bounds on a CUDA device when one is present."""

import jax
import pytest

from kvazaar_jax import devcheck as dc


def test_exact_ops_tiny_widths():
    dev = jax.devices()[0]
    res = {}
    res.update(dc.einsum_mismatches(dev, batch=2))
    res.update(dc.transform_mismatches(dev, pixels=64 * 32, sample=1))
    res.update(dc.intra_mismatches(dev, pixels=32 * 32, sample=1,
                                   sizes=(4, 8)))
    res.update(dc.sad_mismatches(dev, 64, 32, radius=4, size=16))
    res.update(dc.mc_mismatches(dev, 64, 32, cu=16, sample=2))
    assert len(res) == 7 + 10 + 8 + 1 + 2
    assert not any(res.values()), {k: v for k, v in res.items() if v}


def test_recon_parity_across_devices():
    devs = jax.devices()
    same, ms, steps = dc.recon_parity([devs[0], devs[-1]], 64, 48, cu=16,
                                      batch=2, reps=1)
    assert same
    assert ms > 0 and steps == 10


@pytest.mark.gpu
def test_einsum_exact_on_gpu(gpu_device):
    res = dc.einsum_mismatches(gpu_device, batch=4096)
    assert len(res) == 7
    assert not any(res.values()), res
