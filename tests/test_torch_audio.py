"""The port's cross-attention, sinusoidal positions and the audio family
(whisper) against the JAX package on the CPU.

* ``sinusoidal_positions`` bit-equal to JAX's (whisper's 1,500 frames, its
  448-token decoder context and its 8,192-row decode table at d 384);
* ``cross_apply`` at ``reduced(whisper-tiny)`` (d_model 128, 4 heads of
  32, 32 encoder frames; f32): a training call of 8 query rows and a
  one-row decode call (the decode-attention wrapper's plain version on the
  CPU) within atol / rtol 1e-5;
* the model, as ``test_torch_xlstm.family_run`` checks it: logits, loss,
  every grad leaf, three decode steps with their caches (the self
  ``KVCache`` stack and the bare ``enc_out`` array), ``compute_params``
  and the params crossing unchanged;
* a serial ``ServeEngine`` of two requests giving JAX's tokens.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (x64 before any JAX input is built)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402

from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import attention, layers  # noqa: E402
from test_torch_xlstm import (  # noqa: E402
    CELL_TOL,
    DECODE_STEPS,
    ENGINE_REQUESTS,
    check_compute_params,
    check_decode_step,
    check_forward_train,
    check_loss_and_grads,
    check_params_cross,
    cfgs,
    engine_tokens,
    family_run,
)

ARCH = "whisper-tiny"
B, S = 2, 8


@pytest.mark.parametrize("n,d", [(1500, 384), (448, 384), (8192, 384), (7, 6)])
def test_sinusoidal_positions_bit_equal(n, d):
    got = layers.sinusoidal_positions(n, d)
    want = jlayers.sinusoidal_positions(n, d)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    table = layers.position_table(n, d, torch.device("cpu"))
    assert np.array_equal(table.numpy(), want)
    assert layers.position_table(n, d, torch.device("cpu")) is table  # made once


@pytest.mark.parametrize("rows", [S, 1], ids=["train", "decode"])
def test_cross_apply_equals_jax(rows):
    t, j = cfgs(ARCH)
    rng = np.random.default_rng(rows)
    p = {k: (rng.standard_normal(s.shape) * 0.1).astype(np.float32)
         for k, s in jattn.cross_spec(j).items()}
    x = rng.standard_normal((B, rows, t.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, t.enc_frames, t.d_model)).astype(np.float32)
    want = jattn.cross_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jnp.asarray(enc), j)
    got = attention.cross_apply(params_from_numpy(p), torch.from_numpy(x),
                                torch.from_numpy(enc), t)
    assert got.shape == (B, rows, t.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CELL_TOL)


@pytest.fixture(scope="module")
def run():
    return family_run(ARCH)


def test_forward_train_equals_jax(run):
    check_forward_train(run)


def test_loss_and_grads_equal_jax(run):
    check_loss_and_grads(run)


@pytest.mark.parametrize("step", range(DECODE_STEPS))
def test_forward_decode_equals_jax(run, step):
    check_decode_step(run, step)


def test_params_cross_unchanged(run):
    check_params_cross(run)


def test_compute_params_give_the_same_outputs():
    _, cast = check_compute_params(ARCH)
    dec = cast["dec_layers"]
    assert dec["cross"]["wq"].dtype == dec["mlp"]["wi"].dtype == torch.bfloat16
    for norm in (dec["lnx"], cast["enc_ln"], cast["enc_layers"]["ln1"]):
        assert norm["scale"].dtype == norm["bias"].dtype == torch.float32


def test_engine_tokens_equal_jax():
    want, got = engine_tokens(ARCH)
    assert got == want and len(got) == len(ENGINE_REQUESTS)
