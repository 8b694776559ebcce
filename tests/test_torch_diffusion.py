"""The port's diffusion stack (`vegs_torch.diffusion`) against vegs_tpu's.

Both packages get the same weights (`tiny_pair`): the port's seeded tiny
stack, as a Flax tree (`convert.module_to_flax`), with its LoRA
up-projections set non-zero, so the adapters do something, and carried
back to the port with `convert.diffusion_models_from_flax`. Inputs are seeded numpy, NHWC for JAX and NCHW for
the port.

Tolerances (float32 convolutions, matmuls and norms summed in another
order): the schedule's arrays equal to the bit (both build them in float64
numpy and cast once); `add_noise`, `sigma`, `sds_weight` and `ddim_step`
within 1e-6; the `max_step_at` annealing exact, as the jitted JAX step
rounds it; the UNet
and `cfg_noise_pred` within 2e-5 + 1e-4 |ref|; the VAE's moments, sample
and decode within 2e-5 + 1e-4 |ref|. The converters of a diffusers state
dict give the same weights as the JAX converters, equal to the bit (a
rename and copy); LoRA pickles cross between the packages equal to the
bit. `load_sd_checkpoint` on a tiny checkpoint tree (configs patched to
tiny in both packages; a tiny CLIP text encoder saved in the torch and
Flax formats, and a tiny byte-level tokenizer; JAX's init of the fresh
LoRA leaves, which the LoRA file overwrites, replaced by the port's): the
same weights, and text embeddings within 1e-5.
"""

import dataclasses
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_weight_converters import (synthesize_diffusers_unet_state,
                                          synthesize_diffusers_vae_state)
from vegs_torch import convert
from vegs_torch.diffusion import lora as tlora, weights as tweights
from vegs_torch.diffusion.pipeline import DiffusionModels as TModels
from vegs_torch.diffusion.pipeline import (cfg_noise_pred as t_cfg,
                                           encode_image as t_encode)
from vegs_torch.diffusion.scheduler import DiffusionSchedule as TSchedule
from vegs_torch.diffusion.unet import UNetConfig as TUNetConfig
from vegs_torch.diffusion.vae import VAEConfig as TVAEConfig
from vegs_tpu.diffusion import lora as jlora, weights as jweights
from vegs_tpu.diffusion.pipeline import DiffusionModels as JModels
from vegs_tpu.diffusion.pipeline import cfg_noise_pred as j_cfg
from vegs_tpu.diffusion.scheduler import DiffusionSchedule as JSchedule
from vegs_tpu.diffusion.unet import UNetConfig as JUNetConfig
from vegs_tpu.diffusion.vae import VAEConfig as JVAEConfig
from vegs_tpu.losses.sd_guidance import SDGuidance as JGuidance

ATOL, RTOL = 2e-5, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def with_lora_up(params, seed=0):
    """The JAX UNet's params with every lora_up kernel drawn N(0, 0.05)."""
    rng = np.random.default_rng(seed)

    def visit(path, leaf):
        if jlora.is_lora_path(path) and "lora_up" in jax.tree_util.keystr(path):
            return jnp.asarray(rng.normal(0, 0.05, leaf.shape), jnp.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(visit, params)


def port_models(jm):
    """The JAX DiffusionModels carried across to the port, on the CPU."""
    return convert.diffusion_models_from_flax(
        np_tree(jm.unet_params), dataclasses.asdict(jm.unet.config),
        np_tree(jm.vae_params), dataclasses.asdict(jm.vae.config),
        np.asarray(jm.schedule.betas), np.asarray(jm.schedule.alphas_cumprod),
        np.asarray(jm.text_embeddings), device="cpu")


def jax_models(tm):
    """A JAX DiffusionModels holding the port stack `tm`'s weights
    (`convert.module_to_flax`): running Flax's own init of the tiny stack
    takes about a minute on the CPU."""
    from vegs_tpu.diffusion.unet import UNet2DCondition
    from vegs_tpu.diffusion.vae import AutoencoderKL

    ucfg = JUNetConfig(**dataclasses.asdict(tm.unet.config))
    vcfg = JVAEConfig(**dataclasses.asdict(tm.vae.config))
    return JModels(
        unet=UNet2DCondition(ucfg),
        unet_params=jax.tree.map(jnp.asarray,
                                 convert.module_to_flax(tm.unet)),
        vae=AutoencoderKL(vcfg),
        vae_params=jax.tree.map(jnp.asarray, convert.module_to_flax(tm.vae)),
        schedule=JSchedule.scaled_linear(1000),
        text_embeddings=jnp.asarray(tm.text_embeddings.numpy()))


def tiny_pair(seed=0, lora_rank=4):
    """(JAX models, port models) with the same weights: the port's seeded
    tiny stack (LoRA up-projections made non-zero) given to JAX, and JAX's
    carried back across with `convert.diffusion_models_from_flax`."""
    g = torch.Generator()
    g.manual_seed(seed)
    jm = jax_models(TModels.tiny(g, lora_rank=lora_rank))
    if lora_rank:
        jm = jm._replace(unet_params=with_lora_up(jm.unet_params, seed))
    return jm, port_models(jm)


@pytest.fixture(scope="module")
def stacks():
    """{lora rank: (JAX models, port models)} for ranks 0 and 4."""
    return {r: tiny_pair(lora_rank=r) for r in (0, 4)}


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def assert_close_nhwc(got_nchw, want_nhwc, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got_nchw.detach().numpy().transpose(0, 2, 3, 1),
                               np.asarray(want_nhwc), atol=atol, rtol=rtol)


# -- the schedule ------------------------------------------------------------


def test_schedule_matches_jax():
    js = JSchedule.scaled_linear(1000)
    ts = TSchedule.scaled_linear(1000, device="cpu")
    np.testing.assert_array_equal(ts.betas.numpy(), np.asarray(js.betas))
    np.testing.assert_array_equal(ts.alphas_cumprod.numpy(),
                                  np.asarray(js.alphas_cumprod))
    rng = np.random.default_rng(0)
    x0 = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    eps = rng.normal(size=x0.shape).astype(np.float32)
    t = np.array([3, 700])
    np.testing.assert_allclose(
        ts.add_noise(nchw(x0), nchw(eps), torch.from_numpy(t)).numpy()
        .transpose(0, 2, 3, 1),
        np.asarray(js.add_noise(jnp.asarray(x0), jnp.asarray(eps),
                                jnp.asarray(t))), atol=1e-6)
    for tt in (jnp.asarray(t), 500):  # per row, and one scalar timestep
        np.testing.assert_allclose(
            ts.add_noise(nchw(x0), nchw(eps), np.asarray(tt)).numpy()
            .transpose(0, 2, 3, 1),
            np.asarray(js.add_noise(jnp.asarray(x0), jnp.asarray(eps), tt)),
            atol=1e-6)
        np.testing.assert_allclose(ts.sigma(np.asarray(tt)).numpy(),
                                   np.asarray(js.sigma(tt)), atol=1e-6)
        np.testing.assert_allclose(ts.sds_weight(np.asarray(tt)).numpy(),
                                   np.asarray(js.sds_weight(tt)), atol=1e-6)
    for t_prev in (200, -1):
        np.testing.assert_allclose(
            ts.ddim_step(nchw(x0), nchw(eps), 500, t_prev).numpy()
            .transpose(0, 2, 3, 1),
            np.asarray(js.ddim_step(jnp.asarray(x0), jnp.asarray(eps), 500,
                                    t_prev)), atol=1e-6)


def test_max_step_annealing_matches_the_jax_step():
    """`max_step_at` as the jitted JAX step computes it from its int32
    counter, over a window and its edges: XLA turns the division into a
    multiplication by a float32 reciprocal fused with 1 - frac, so halfway
    through a 28-iteration window it gives 24, where exact arithmetic (and
    JAX without jit) gives 25."""
    from vegs_torch.losses.sd_guidance import SDGuidance

    for start, end, top in ((2, 30, 50), (97_500, 100_000, 50),
                            (3000, 3013, 37)):
        jg = JGuidance(None, start_iter=start, max_iters=end, max_step=top)
        jstep = jax.jit(jg.max_step_at)
        tg = SDGuidance.__new__(SDGuidance)
        tg.start_iter, tg.max_iters, tg.max_step = start, end, top
        its = range(start - 2, end + 3)
        assert [tg.max_step_at(it) for it in its] == [
            int(jstep(jnp.int32(it))) for it in its]
    tg.start_iter, tg.max_iters, tg.max_step = 2, 30, 50
    assert tg.max_step_at(16) == 24 != int(JGuidance(
        None, start_iter=2, max_iters=30, max_step=50).max_step_at(16))


# -- UNet, VAE, CFG ------------------------------------------------------------


@pytest.mark.parametrize("rank", [0, 4])
def test_unet_matches_jax(stacks, rank):
    jm, tm = stacks[rank]
    rng = np.random.default_rng(2)
    lat = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    t = np.array([3, 700])
    ctx = np.repeat(np.asarray(jm.text_embeddings[:1]), 2, axis=0)
    want = jm.unet.apply(jm.unet_params, jnp.asarray(lat), jnp.asarray(t),
                         jnp.asarray(ctx))
    with torch.no_grad():
        got = tm.unet(nchw(lat), torch.from_numpy(t), torch.from_numpy(ctx))
    assert_close_nhwc(got, want)
    if rank:  # the adapters are live: the UNet without them differs
        with torch.no_grad():
            base = stacks[0][1].unet(nchw(lat), torch.from_numpy(t),
                                     torch.from_numpy(ctx))
        assert (got - base).abs().max() > 1e-3


def test_vae_matches_jax(stacks):
    jm, tm = stacks[0]
    rng = np.random.default_rng(3)
    img = rng.uniform(size=(1, 32, 32, 3)).astype(np.float32)
    x = img * 2 - 1
    jmean, jlogvar = jm.vae.apply(jm.vae_params, jnp.asarray(x),
                                  method="encode_moments")
    with torch.no_grad():
        tmean, tlogvar = tm.vae.encode_moments(nchw(x))
    assert_close_nhwc(tmean, jmean)
    assert_close_nhwc(tlogvar, jlogvar)
    # a sample with JAX's own draw, replayed
    key = jax.random.key(4)
    want = jm.vae.apply(jm.vae_params, jnp.asarray(x), key, method="encode")
    eps = np.asarray(jax.random.normal(key, jmean.shape))
    with torch.no_grad():
        got = tm.vae.encode(nchw(x), nchw(eps))
        chw = torch.from_numpy(img[0].transpose(2, 0, 1).copy())
        assert torch.equal(t_encode(tm, chw, nchw(eps)), got)
    assert_close_nhwc(got, want)
    with torch.no_grad():
        rec = tm.vae.decode(got)
    assert_close_nhwc(rec, jm.vae.apply(jm.vae_params, want, method="decode"))


@pytest.mark.parametrize("orientation", [True, False])
def test_cfg_noise_pred_matches_jax(stacks, orientation):
    jm, tm = stacks[4]
    rng = np.random.default_rng(5)
    lat = rng.normal(size=(1, 8, 8, 4)).astype(np.float32)
    t = np.array([100])
    want = j_cfg(jm, jnp.asarray(lat), jnp.asarray(t), 7.5, orientation)
    with torch.no_grad():
        got = t_cfg(tm, nchw(lat), torch.from_numpy(t), 7.5, orientation)
        other = t_cfg(tm, nchw(lat), torch.from_numpy(t), 7.5, not orientation)
    assert_close_nhwc(got, want)
    assert (got - other).abs().max() > 1e-3


# -- weights: converters, LoRA files, checkpoints --------------------------------


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(v)
    return out


def assert_same_weights(port_module, jax_params, skip_lora=False):
    got = _flat(convert.module_to_flax(port_module))
    want = _flat(np_tree(jax_params))
    if skip_lora:
        got = {k: v for k, v in got.items() if not tlora.is_lora_path(k)}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("rank", [0, 4])
def test_diffusers_converters_match_jax(rank):
    ucfg = JUNetConfig.tiny(lora_rank=rank)
    state = synthesize_diffusers_unet_state(ucfg, np.random.default_rng(0))
    junet = jweights.convert_unet_state(state, ucfg)
    tunet = tweights.convert_unet_state(
        state, TUNetConfig.tiny(lora_rank=rank), device="cpu")
    assert_same_weights(tunet, junet, skip_lora=bool(rank))
    if rank:  # fresh adapters: lora_up zero, so they add nothing yet
        ups = [p for n, p in tunet.named_parameters() if "lora_up" in n]
        assert ups and all(bool((p == 0).all()) for p in ups)
    vstate = synthesize_diffusers_vae_state(JVAEConfig.tiny(),
                                            np.random.default_rng(1))
    assert_same_weights(
        tweights.convert_vae_state(vstate, TVAEConfig.tiny(), device="cpu"),
        jweights.convert_vae_state(vstate, JVAEConfig.tiny()))
    del state["conv_in.weight"]
    with pytest.raises(KeyError, match="conv_in.weight"):
        tweights.convert_unet_state(state, TUNetConfig.tiny(), device="cpu")


def test_lora_files_cross_between_packages(stacks, tmp_path):
    jm, tm = stacks[4]
    jflat = jlora.split_lora(jm.unet_params)
    tflat = tlora.split_lora(tm.unet)
    assert sorted(jflat) == sorted(tflat) and len(jflat) > 0
    for k in jflat:
        np.testing.assert_array_equal(tflat[k], jflat[k])
    assert sum(tlora.lora_mask(tm.unet).values()) == len(jflat)
    # JAX writes, the port reads
    jlora.save_lora_weights(jm.unet_params, tmp_path / "j" / "lora_weights.pkl")
    fresh = tiny_pair(seed=9)[1].unet
    tlora.load_lora_weights(fresh, tmp_path / "j")
    for k, v in tlora.split_lora(fresh).items():
        np.testing.assert_array_equal(v, jflat[k])
    # the port writes, JAX reads
    perturbed = {n: p.detach() + 0.25 for n, p in tm.unet.named_parameters()
                 if tlora.is_lora_path(n)}
    with torch.no_grad():
        for n, p in fresh.named_parameters():
            if n in perturbed:
                p.copy_(perturbed[n])
    tlora.save_lora_weights(fresh, tmp_path / "t.pkl")
    with open(tmp_path / "t.pkl", "rb") as f:
        assert all(isinstance(v, np.ndarray) for v in pickle.load(f).values())
    back = jlora.split_lora(jlora.load_lora_weights(jm.unet_params,
                                                    str(tmp_path / "t.pkl")))
    for k, v in tlora.split_lora(fresh).items():
        np.testing.assert_array_equal(back[k], v)


def _tiny_clip_tree(root, hidden):
    """tokenizer/ (a byte-level CLIP vocabulary, no merges) and
    text_encoder/ (a 2-layer CLIP text model, torch and Flax weights)."""
    import json

    from transformers import (CLIPTextConfig, CLIPTextModel, CLIPTokenizer,
                              FlaxCLIPTextModel)
    from transformers.models.clip.tokenization_clip import bytes_to_unicode

    chars = list(bytes_to_unicode().values())
    vocab = {c: i for i, c in enumerate(chars)}
    vocab.update({c + "</w>": i + len(chars) for i, c in enumerate(chars)})
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    tok_dir = root / "tokenizer"
    tok_dir.mkdir(parents=True)
    (tok_dir / "vocab.json").write_text(json.dumps(vocab))
    (tok_dir / "merges.txt").write_text("#version: 0.2\n")
    CLIPTokenizer(str(tok_dir / "vocab.json"), str(tok_dir / "merges.txt"),
                  model_max_length=64).save_pretrained(tok_dir)
    torch.manual_seed(0)
    enc = CLIPTextModel(CLIPTextConfig(
        vocab_size=len(vocab), hidden_size=hidden, intermediate_size=37,
        num_attention_heads=4, num_hidden_layers=2,
        max_position_embeddings=64, bos_token_id=vocab["<|startoftext|>"],
        eos_token_id=vocab["<|endoftext|>"]))
    enc_dir = root / "text_encoder"
    enc.save_pretrained(enc_dir)
    FlaxCLIPTextModel.from_pretrained(str(enc_dir), from_pt=True
                                      ).save_pretrained(enc_dir)


def test_load_sd_checkpoint_matches_jax(stacks, tmp_path, monkeypatch):
    pytest.importorskip("transformers",
                        reason="the text encoder needs transformers")
    from safetensors.numpy import save_file

    from vegs_tpu.diffusion import unet as junet_mod, vae as jvae_mod
    from vegs_torch.diffusion import unet as tunet_mod, vae as tvae_mod

    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    for mod, cls, name, tiny in (
            (junet_mod, "UNetConfig", "sd21", JUNetConfig.tiny()),
            (tunet_mod, "UNetConfig", "sd21", TUNetConfig.tiny()),
            (jvae_mod, "VAEConfig", "sd", JVAEConfig.tiny()),
            (tvae_mod, "VAEConfig", "sd", TVAEConfig.tiny())):
        monkeypatch.setattr(getattr(mod, cls), name,
                            staticmethod(lambda t=tiny: t))
    # JAX's loader inits a whole UNet only for the LoRA leaves the file
    # then overwrites; Flax's init of it takes ~40 s on the CPU, so it gets
    # the port's init as a Flax tree
    monkeypatch.setattr(junet_mod, "init_unet", lambda key, cfg, image_size: (
        convert.module_to_flax(tiny_pair(seed=3)[1].unet)))
    root = tmp_path / "sd"
    ustate = synthesize_diffusers_unet_state(JUNetConfig.tiny(),
                                             np.random.default_rng(0))
    (root / "unet").mkdir(parents=True)
    save_file(ustate, str(root / "unet" / "diffusion_pytorch_model.safetensors"))
    vstate = synthesize_diffusers_vae_state(JVAEConfig.tiny(),
                                            np.random.default_rng(1))
    (root / "vae").mkdir()
    torch.save({k: torch.from_numpy(v) for k, v in vstate.items()},
               root / "vae" / "diffusion_pytorch_model.bin")
    _tiny_clip_tree(root, JUNetConfig.tiny().cross_attention_dim)

    # a LoRA file from the JAX package, with every adapter non-zero
    jl = with_lora_up(stacks[4][0].unet_params, seed=1)
    jlora.save_lora_weights(jl, tmp_path / "lora" / "lora_weights.pkl")

    for lora_dir in (None, str(tmp_path / "lora")):
        jm = jweights.load_sd_checkpoint(str(root), "a street", "",
                                         lora_dir=lora_dir)
        tm = tweights.load_sd_checkpoint(str(root), "a street", "",
                                         lora_dir=lora_dir, device="cpu")
        assert_same_weights(tm.unet, jm.unet_params)
        assert_same_weights(tm.vae, jm.vae_params)
        np.testing.assert_array_equal(tm.schedule.alphas_cumprod.numpy(),
                                      np.asarray(jm.schedule.alphas_cumprod))
        assert tuple(tm.text_embeddings.shape) == jm.text_embeddings.shape \
            == (2, 64, JUNetConfig.tiny().cross_attention_dim)
        np.testing.assert_allclose(tm.text_embeddings.numpy(),
                                   np.asarray(jm.text_embeddings), atol=1e-5)
    fresh = tweights.load_sd_checkpoint(str(root), "a street", "",
                                        lora_dir="init", device="cpu")
    assert all(bool((p == 0).all()) for n, p in fresh.unet.named_parameters()
               if "lora_up" in n)
    assert os.path.isdir(root / "tokenizer")
