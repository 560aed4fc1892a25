"""Files the JAX package wrote, read by the port: a tiny Llama's
``.pdparams`` (f32 and bf16) and ``.pdopt`` written by ``paddle_tpu.save``
load through ``paddle_tpu_torch.framework.io.load`` and
``hapi.Model.load``, on the CPU.

The loaded model gives the JAX model's logits (f32, rtol 1e-5 and atol
1e-5: two libraries' matmuls); bf16 arrays come back as ``torch.bfloat16``
with the JAX array's bits; the optimizer state crosses through
``convert`` and the next AdamW step's loss matches the JAX step's within
1e-5 (relative). A process of its own shows that the load imports
neither the JAX package, jax nor ``ml_dtypes``; a file naming any other
global is refused.
"""

import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlamaForCausalLM

from paddle_tpu_torch import convert
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.framework import io as tio
from paddle_tpu_torch.hapi import Model
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

REPO = Path(__file__).resolve().parents[1]

torch.set_num_threads(1)


def _ids(step):
    return np.random.RandomState(70 + step).randint(0, 256, (2, 17))


def _jax_opt(jm):
    return paddle.optimizer.AdamW(learning_rate=1e-2,
                                  parameters=jm.parameters(),
                                  weight_decay=0.01)


def _jax_step(jm, opt, ids):
    t = paddle.to_tensor(ids)
    _, loss = jm(t, labels=t)
    loss.backward()
    opt.step()
    opt.clear_grad()
    return float(loss.numpy())


@pytest.fixture(scope="module")
def jax_files(tmp_path_factory):
    """The JAX model after 2 AdamW steps, saved in f32 (``f32.pdparams``,
    ``f32.pdopt``) and with its weights cast to bf16 (``bf16.pdparams``,
    the same ``.pdopt``). Returns the directory, the config and the
    weights of each file as numpy arrays."""
    d = tmp_path_factory.mktemp("jax_ckpt")
    cfg = JLlamaConfig.tiny()
    cfg.tensor_parallel = False
    cfg.scan_layers = False
    paddle.seed(0)
    jm = JLlamaForCausalLM(cfg)
    jm.train()
    jopt = _jax_opt(jm)
    for s in range(2):
        _jax_step(jm, jopt, _ids(s))
    paddle.save(jm.state_dict(), str(d / "f32.pdparams"))
    paddle.save(jopt.state_dict(), str(d / "f32.pdopt"))
    paddle.save(jopt.state_dict(), str(d / "bf16.pdopt"))
    f32 = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    jm.to(dtype="bfloat16")
    paddle.save(jm.state_dict(), str(d / "bf16.pdparams"))
    bf16 = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    return d, cfg, {"f32": f32, "bf16": bf16}


def _jax_model(cfg, arrays):
    """A JAX model in f32 holding ``arrays`` (bf16 values are exact in
    f32)."""
    jm = JLlamaForCausalLM(cfg)
    jm.set_state_dict({k: paddle.to_tensor(v.astype(np.float32))
                       for k, v in arrays.items()})
    jm.train()
    return jm


def _port_model():
    cfg = dataclasses.replace(LlamaConfig.tiny(), scan_layers=False)
    net = LlamaForCausalLM(cfg, device="cpu", seed=5)
    net.train()
    m = Model(net)
    opt = topt.AdamW(learning_rate=1e-2, parameters=net.parameters(),
                     weight_decay=0.01)
    m.prepare(opt)
    return m, net, opt


def _logits_match(net, jm, ids):
    jm.eval()
    net.eval()
    jl = np.asarray(jm(paddle.to_tensor(ids)).numpy())
    with torch.no_grad():
        tl = net(torch.from_numpy(ids)).numpy()
    jm.train()
    net.train()
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_model_load_gives_the_jax_logits(jax_files, dtype):
    d, cfg, arrays = jax_files
    m, net, _ = _port_model()
    m.load(str(d / dtype))
    _logits_match(net, _jax_model(cfg, arrays[dtype]), _ids(9))


def test_io_load_reads_jax_arrays_and_bf16_bits(jax_files):
    d, _, arrays = jax_files
    bf16 = arrays["bf16"]
    obj, origin = tio.read(str(d / "bf16.pdparams"), device="cpu")
    assert origin == "jax"
    assert set(obj) == set(bf16)
    for k, v in bf16.items():
        assert obj[k].dtype == torch.bfloat16, k
        np.testing.assert_array_equal(obj[k].view(torch.int16).numpy(),
                                      v.view(np.int16), err_msg=k)
    f32 = tio.load(str(d / "f32.pdparams"), device="cpu")
    for k, v in arrays["f32"].items():
        assert f32[k].dtype == torch.float32, k
        np.testing.assert_array_equal(f32[k].numpy(), v, err_msg=k)
    # numpy arrays on request: bf16 as f32
    key = "llama.layers.0.self_attn.q_proj.weight"
    back = tio.load(str(d / "bf16.pdparams"), return_numpy=True)
    assert back[key].dtype == np.float32
    np.testing.assert_array_equal(back[key], bf16[key].astype(np.float32))


def test_io_load_gives_writable_tensors_over_their_own_bytes(tmp_path,
                                                           monkeypatch):
    """``framework.io.load(..., device="cpu")`` of a two-tensor dict (f32
    and bf16: an ml_dtypes array in the JAX file, the uint16 view in the
    port's) hands every tensor writable memory of its own: no array
    reaches ``torch.from_numpy`` read-only (numpy over the pickle's
    immutable bytes), no ``UserWarning`` is raised, and an in-place
    ``add_`` leaves what the next load reads unchanged."""
    import warnings

    import jax.numpy as jnp
    rng = np.random.RandomState(4)
    f32 = rng.randn(3, 5).astype(np.float32)
    b16 = jnp.asarray(rng.randn(4, 2), jnp.bfloat16)
    jax_path = str(tmp_path / "jax.pdparams")
    paddle.save({"w": paddle.to_tensor(f32), "b": paddle.Tensor(b16)},
                jax_path)
    port_path = str(tmp_path / "port.pdparams")
    tio.save({"w": torch.from_numpy(f32),
              "b": torch.from_numpy(np.array(b16).view(np.uint16))
              .view(torch.bfloat16)}, port_path)
    real = torch.from_numpy

    def writable_only(arr):
        assert arr.flags.writeable, "a read-only array reached from_numpy"
        return real(arr)

    monkeypatch.setattr(torch, "from_numpy", writable_only)
    for path in (jax_path, port_path):
        with warnings.catch_warnings():
            warnings.simplefilter("error", UserWarning)
            obj = tio.load(path, device="cpu")
            before = {k: v.clone() for k, v in obj.items()}
            assert obj["b"].dtype == torch.bfloat16
            for t in obj.values():
                t.add_(1)
            again = tio.load(path, device="cpu")
        for k in obj:
            assert torch.equal(again[k], before[k]), (path, k)
            assert torch.equal(obj[k], before[k] + 1), (path, k)


def test_the_optimizer_state_crosses_and_the_next_step_agrees(jax_files):
    """After ``Model.load`` the port's AdamW continues the JAX run: the
    next step's loss within 1e-5 (relative) and its weights within rtol
    1e-4 / atol 1e-5 of the JAX step's; without the ``.pdopt`` (a fresh
    AdamW) the weights come out elsewhere."""
    d, cfg, arrays = jax_files
    jm = _jax_model(cfg, arrays["f32"])
    jopt = _jax_opt(jm)
    jopt.set_state_dict(paddle.load(str(d / "f32.pdopt")))
    jl = _jax_step(jm, jopt, _ids(2))
    want = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    t = torch.from_numpy(_ids(2))
    got = {}
    for reset in (False, True):
        m, net, opt = _port_model()
        m.load(str(d / "f32"), reset_optimizer=reset)
        _, loss = net(t, labels=t)
        loss.backward()
        opt.step()
        opt.clear_grad()
        assert abs(loss.item() - jl) <= 1e-5 * abs(jl)
        got[reset] = convert.to_numpy_state_dict(net)
    key = "llama.layers.1.mlp.up_proj.weight"
    for k, v in want.items():
        np.testing.assert_allclose(got[False][k], v, rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    assert np.abs(got[True][key] - want[key]).max() > 1e-3


def test_the_load_imports_neither_jax_nor_ml_dtypes(jax_files):
    d = jax_files[0]
    code = (
        "import sys, dataclasses\n"
        "from paddle_tpu_torch.hapi import Model\n"
        "from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM\n"
        "from paddle_tpu_torch.optimizer import AdamW\n"
        "net = LlamaForCausalLM(dataclasses.replace(LlamaConfig.tiny(), "
        "scan_layers=False), device='cpu')\n"
        "m = Model(net)\n"
        "m.prepare(AdamW(parameters=net.parameters()))\n"
        f"m.load({str(d / 'bf16')!r})\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'paddle_tpu', 'ml_dtypes'))\n"
        "print('LOADED', bad)\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "LOADED []" in r.stdout, r.stdout


class _Evil:
    def __reduce__(self):
        return (os.getcwd, ())


def test_a_file_naming_another_global_is_refused(tmp_path):
    path = tmp_path / "evil.pdparams"
    path.write_bytes(pickle.dumps({"w": _Evil()}, protocol=4))
    with pytest.raises(pickle.UnpicklingError, match="posix.getcwd"):
        tio.load(str(path), device="cpu")
    # the port's own files still load, OrderedDict state dicts included
    net = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    tio.save(net.state_dict(), str(tmp_path / "own.pdparams"))
    back, origin = tio.read(str(tmp_path / "own.pdparams"), device="cpu")
    assert origin == "port"
    for k, v in net.state_dict().items():
        assert torch.equal(back[k], v), k
