"""The port's loss and gradients against the JAX package's, in process
(``repro.train`` and ``repro.optim`` do not reach ``repro.core``).

For every reduced config of the six families in f32 (whisper-base with
``frames``, internvl2-76b with ``patches`` in the batch, which the
reference's training CLI does not pass), both packages get the same
parameters (``torch_train_common.setup``); the reference runs
``jax.value_and_grad`` of its ``make_loss_fn`` on its default jnp path, as
its own training does, the port ``make_grad_fn`` with remat.

Tolerances: the loss and its metrics within rtol 1e-5, each gradient leaf
within 1e-5 + 1e-4·max|g| (only the frameworks' f32 summation order
differs); ``remat`` changes no bit on the CPU.
"""

import jax
import numpy as np
import pytest
import torch
from repro.train.train_step import make_loss_fn as jax_make_loss_fn

from repro_torch.models.convert import named_arrays
from repro_torch.models.registry import ALL_ARCHS
from repro_torch.train.train_step import make_grad_fn
from torch_train_common import batch_of, grads_close, jax_batch, setup, torch_batch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small ops; with the several pytest workers a test run starts
    side by side, each op's intra-op thread team waits on the others'."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_loss_and_every_gradient_match_the_reference(arch):
    japi, api, cfg, tree, params = setup(arch)
    batch = batch_of(cfg, seed=1, mask=arch in ("qwen2.5-3b", "internvl2-76b"))
    fn = jax.jit(jax.value_and_grad(jax_make_loss_fn(japi, cfg, remat=False), has_aux=True))
    (jloss, jmetrics), jgrads = fn(tree, jax_batch(batch))

    grads, metrics = make_grad_fn(api, cfg, remat=True)(params, torch_batch(batch))
    np.testing.assert_allclose(float(metrics["loss"]), float(jloss), rtol=1e-5)
    for k in ("nll", "z_loss", "moe_aux", "tokens"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    grads_close(grads, named_arrays(jgrads, cfg), arch)
    if cfg.family == "moe":  # the router gets the load-balance loss's gradient too
        router = [k for k in grads if k.endswith("router.w")]
        assert router and all(float(grads[k].abs().max()) > 0 for k in router)


@pytest.mark.parametrize("arch", ["gemma2-2b", "zamba2-7b", "whisper-base", "qwen3-moe-30b-a3b", "internvl2-76b"])
def test_remat_changes_no_bit(arch):
    _, api, cfg, _, params = setup(arch)
    batch = torch_batch(batch_of(cfg, seed=2))
    with_remat, m1 = make_grad_fn(api, cfg, remat=True)(params, batch)
    without, m2 = make_grad_fn(api, cfg, remat=False)(params, batch)
    assert torch.equal(m1["loss"], m2["loss"])
    for k in with_remat:
        assert torch.equal(with_remat[k], without[k]), k


def test_microbatches_must_divide_the_batch():
    _, api, cfg, _, params = setup("qwen2.5-3b")
    with pytest.raises(ValueError, match="microbatches"):
        make_grad_fn(api, cfg, microbatches=3)(params, torch_batch(batch_of(cfg, seed=0, batch=4)))


def test_a_parameter_the_loss_does_not_reach_gets_a_zero_gradient():
    _, api, cfg, _, params = setup("qwen2.5-3b")
    extra = torch.nn.Parameter(torch.ones(3))
    params.register_parameter("unused", extra)
    grads, _ = make_grad_fn(api, cfg)(params, torch_batch(batch_of(cfg, seed=0)))
    assert torch.equal(grads["unused"], torch.zeros(3))
    assert all(float(g.abs().max()) > 0 for k, g in grads.items() if k != "unused")
