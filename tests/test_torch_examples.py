"""The port's example CLIs (``sageattention_tpu_torch/examples``) on the CPU:
the slice as a whole against the JAX package's ``examples/``.

* ``scaled_config`` equals the JAX ``examples/common.scaled_config`` field
  for field, for every DiT at scales 0.05, 0.25 and 1.0.
* ``run_video_example`` fed converted flax weights and the JAX inputs
  gives, after the first step and 2 timed steps, the latents of the JAX
  runner's ``denoise_step`` loop on the same schedule, whose attention goes
  through a test-side backend calling ``core._sageattn_hnd(impl="xla",
  chunk_k=G)`` (``core._entry`` raises at this revision; the
  ``tests/test_torch_dit.py`` pattern): fp32 cosine >= 0.9999 and max-abs
  <= 1e-3, the tolerances of ``tests/test_torch_dit.py``.
* Each CLI's ``main([..., "--device", "cpu"])`` runs at a tiny size and
  returns what it printed: the CogVideoX-2B CLI at its width (1,920) with
  ``--compare`` (eps cosine against "sdpa" >= 0.999), the wider video
  CLIs with a narrowed ``cfg`` (their class choice is what is tested), the
  LLM CLIs, training with a checkpoint and a resume, the injected
  processor, sharded serving (shards in turn), and in a gloo world of 2
  the parallel video CLI (ring 2), sharded serving over a mesh (its bf16
  output equal to the shards run in turn in one process, rounded to bf16,
  within bf16's default tolerance) and data-parallel training (both
  ranks' losses equal).
"""

from __future__ import annotations

import dataclasses
import pathlib
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from sageattention_tpu_torch import models  # noqa: E402
from sageattention_tpu_torch.examples import (  # noqa: E402
    cogvideox1_5_5b,
    cogvideox_2b,
    common,
    hunyuanvideo,
    llm_decode,
    llm_prefill,
    mochi,
    modify_model,
    parallel_video,
    sharded_serving,
    train_dit,
    wan,
)
from sageattention_tpu_torch.utils.compare import cosine_similarity  # noqa: E402

if "--worker" not in sys.argv:  # the spawned ranks import torch and the port only
    import jax
    import jax.numpy as jnp
    from test_torch_dit import _tiny, _xla_sage
    from test_torch_parallel import result, spawn_world

    from examples import common as jcommon
    from sageattention_tpu import models as jmodels
    from sageattention_tpu.models.attention import register_backend as j_register
    from sageattention_tpu.models.configs import MODEL_CONFIGS as J_CONFIGS
    from sageattention_tpu_torch.models.convert import params_from_jax

CPU = ["--device", "cpu"]


def narrow(name: str):
    """A video config at its model's layout, narrowed for the CPU."""
    return common.scaled_config(name, 0.05).scaled(hidden=256, heads=4, head_dim=64)


def tiny_llm():
    return models.MODEL_CONFIGS["llm-8b-gqa"].scaled(hidden=256, heads=4, kv_heads=2,
                                                     head_dim=64, depth=1, vocab=1000,
                                                     mlp_hidden=512)


def tiny_dit():
    return models.MODEL_CONFIGS["cogvideox-2b"].scaled(
        depth=2, latent_frames=2, latent_height=8, latent_width=8, text_len=16, hidden=128,
        heads=2, head_dim=64)


@pytest.mark.parametrize("scale", [0.05, 0.25, 1.0])
@pytest.mark.parametrize("name", [n for n, c in models.MODEL_CONFIGS.items()
                                  if isinstance(c, models.DiTConfig)])
def test_scaled_config_matches_jax(name, scale):
    got = dataclasses.asdict(common.scaled_config(name, scale))
    want = dataclasses.asdict(jcommon.scaled_config(name, scale))
    assert got == want


@pytest.fixture
def jax_sage_backend():
    j_register("torch_port_xla_sage", _xla_sage)
    prev = jmodels.get_attention_backend()
    jmodels.set_attention_backend("torch_port_xla_sage")
    yield
    jmodels.set_attention_backend(prev)


def test_run_video_example_matches_the_jax_loop(jax_sage_backend):
    cfg_j, cfg_t = _tiny(J_CONFIGS), _tiny(models.MODEL_CONFIGS)
    rng = np.random.default_rng(0)
    lat = rng.standard_normal((1, 2, 16, 16, 16)).astype(np.float32)
    txt = rng.standard_normal((1, 16, 512)).astype(np.float32)
    jm = jmodels.VideoDiT(cfg_j, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(lat), jnp.asarray(txt),
                     jnp.array([999]))
    sd = params_from_jax(jax.tree.map(np.asarray, params))

    def step(x, t):  # the JAX runner's denoise_step
        eps = jm.apply(params, x, jnp.asarray(txt), jnp.array([t]))
        return x - (1.0 / 50) * eps.astype(x.dtype)

    want = jnp.asarray(lat)
    for t in (999, 999, 500):  # the first step, then 2 steps: 999 - i * (999 // 2)
        want = step(want, t)
    out = cogvideox_2b.main(CPU + ["--steps", "2"], cfg=cfg_t, state_dict=sd,
                            inputs=(torch.from_numpy(lat), torch.from_numpy(txt)))
    got = out["latents"]
    assert got.dtype == torch.float32 and len(out["step_ms"]) == 2
    assert cosine_similarity(got, np.asarray(want)) >= 0.9999
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)


def test_cogvideox_2b_cli_at_its_width(tmp_path):
    out = cogvideox_2b.main(CPU + ["--scale", "0.05", "--steps", "1", "--compare",
                                   "--profile", str(tmp_path)])
    assert (out["heads"], out["head_dim"], out["depth"]) == (30, 64, 2)
    assert out["class"] == "VideoDiT" and out["device"] == "cpu" and out["peak_gib"] is None
    assert out["cosine_vs_sdpa"] >= 0.999
    assert pathlib.Path(out["profile"]).exists() and len(out["step_ms"]) == 1
    assert torch.isfinite(out["latents"]).all()
    assert models.get_attention_backend() == "sage"


@pytest.mark.parametrize("mod,name,cls", [
    (cogvideox1_5_5b, "cogvideox1.5-5b", "VideoDiT"),
    (hunyuanvideo, "hunyuanvideo", "DualStreamVideoDiT"),
    (mochi, "mochi-1", "DualStreamVideoDiT"),
    (wan, "wan2.1-t2v-1.3b", "CrossAttnVideoDiT"),
])
def test_video_clis_run_their_model_class(mod, name, cls):
    out = mod.main(CPU + ["--steps", "1", "--compare", "--attention_type", "sage_fp8"],
                   cfg=narrow(name))
    assert out["model"] == name and out["class"] == cls and out["backend"] == "sage_fp8"
    assert out["cosine_vs_sdpa"] >= 0.999
    assert torch.isfinite(out["latents"]).all()


def test_modify_model_injects_the_processor():
    out = modify_model.main(CPU + ["--scale", "0.05"])
    assert out["processor"] == {"backend": "sage", "kwargs": {"pv_dtype": "int8"}}
    assert out["cosine_vs_sdpa"] >= 0.999
    assert models.get_attention_backend() == "sage"


def test_llm_prefill_cli():
    out = llm_prefill.main(CPU + ["--seq", "256", "--compare"], cfg=tiny_llm())
    assert out["seq"] == 256 and out["prefill_ms"] > 0
    assert out["cosine_vs_sdpa"] >= 0.999


@pytest.mark.parametrize("extra", [
    ["--paged", "--bits", "4", "--speculate", "2", "--page_size", "64"],
    ["--chunked_prefill", "64"],
])
def test_llm_decode_cli(extra):
    out = llm_decode.main(CPU + ["--scale", "0.02", "--prompt_len", "128", "--gen", "6",
                                 "--max_len", "256"] + extra)
    assert out["config"]["kv_heads"] == 2 and out["config"]["hidden"] == 128
    assert len(out["tokens"]) == 7 and out["decode_tokens"] > 0
    if "--speculate" in extra:
        assert out["drafted"] == 2 * out["rounds"] and 0 <= out["acceptance"] <= 1


def test_train_dit_checkpoint_and_resume(tmp_path):
    ckpt = ["--ckpt_dir", str(tmp_path), "--lr", "1e-3"]
    first = train_dit.main(CPU + ["--steps", "3"] + ckpt, cfg=tiny_dit())
    assert first["start"] == 0 and len(first["losses"]) == 3
    assert first["losses"][-1] < first["losses"][0]
    # the first step of a run is untimed: a one-step resume has no mean
    assert first["avg_step_ms"] == sum(first["step_ms"][1:]) / 2
    resumed = train_dit.main(CPU + ["--steps", "4"] + ckpt, cfg=tiny_dit())
    assert resumed["start"] == 3 and len(resumed["losses"]) == 1
    assert "avg_step_ms" not in resumed
    done = train_dit.main(CPU + ["--steps", "4"] + ckpt, cfg=tiny_dit())
    assert done["start"] == 4 and done["losses"] == []
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000002.pt",
                                                        "step_00000003.pt"]


SHARDED = ["--context", "512", "--gen", "2", "--window", "256"]


def test_sharded_serving_cli_runs_the_shards_in_turn():
    out = sharded_serving.main(CPU + ["--tp", "2", "--sp", "2"] + SHARDED)
    assert out["shards"] == 4 and out["context"] == 512 and out["prompt"] == 510
    assert out["output"].shape == (1, 8, 1, 128) and np.isfinite(out["output_norm"])


# --------------------------------------------------------------------------
# a gloo world of 2: the CLIs that run one process a rank
# --------------------------------------------------------------------------


CASES = {
    "parallel_video": lambda rank: parallel_video.main(
        CPU + ["--smoke", "--ring_degree", "2", "--scale", "0.05", "--steps", "1"]),
    "sharded_serving": lambda rank: sharded_serving.main(CPU + ["--tp", "1", "--sp", "2"]
                                                         + SHARDED),
    "train_dit_dp": lambda rank: train_dit.main(CPU + ["--dp", "2", "--steps", "2",
                                                       "--lr", "1e-3"], cfg=tiny_dit()),
}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return spawn_world(__file__, tmp_path_factory.mktemp("examples_world"), world=2)


def test_parallel_video_cli_in_a_world_of_two(world):
    outs = [result(world, "parallel_video", r) for r in range(2)]
    assert [o["rank"] for o in outs] == [0, 1] and outs[0]["world"] == 2
    assert outs[0]["ring"] == 2 and outs[0]["seq_len"] % 2 == 0
    assert torch.equal(outs[0]["latents"], outs[1]["latents"])
    assert torch.isfinite(outs[0]["latents"]).all()


def test_sharded_serving_cli_over_a_mesh(world):
    outs = [result(world, "sharded_serving", r) for r in range(2)]
    here = sharded_serving.main(CPU + ["--tp", "1", "--sp", "2"] + SHARDED)
    for o in outs:
        assert o["shards"] == 2 and o["context"] == here["context"]
        # the mesh's merged output comes back in q's dtype (bf16), the shards
        # merged in one process in fp32: equal up to that rounding
        torch.testing.assert_close(o["output"], here["output"].to(o["output"].dtype))


def test_train_dit_data_parallel(world):
    outs = [result(world, "train_dit_dp", r) for r in range(2)]
    assert outs[0]["dp"] == 2 and outs[0]["losses"] == outs[1]["losses"]
    assert outs[0]["losses"][-1] < outs[0]["losses"][0]


if __name__ == "__main__":
    from test_torch_parallel import worker_main

    worker_main(CASES, sys.argv)
