"""The encoder-decoder on a (data, model) mesh, held to the JAX package,
on CPU gloo ranks (bodies in ``tests/_torch_train_ranks.py``, which
imports no JAX).

Each rank holds its rows of the batch, of the frames and of the decoder
tokens (``training/train_step.rank_rows``); the encoder attends its
frames to every frame, the decoder its tokens causally at its q_offset
and across to every frame (``models/encdec.py``).  Reduced whisper-small
trains 3 AdamW steps at (1, 2) and (2, 2), held to JAX's one-device step
and at (2, 2) to JAX's own (2, 2) mesh (``tests/_torch_mesh_pair.py``).
The frame split and the frontend's position rows are checked on their
own, and the launcher trains xlstm-125m and hymba-1.5b at --data 2
--model-axis 2 (whisper's refusal, for want of frame embeddings, is
``test_torch_whisper.py``'s).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.layers.frontend import (apply_frontend,  # noqa: E402
                                         init_frontend)
from repro_torch.training.train_step import rank_rows  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_mesh_pair import (ROOT, JaxMesh, check_ranks,  # noqa: E402
                              configs, jax_run, port_run)

ARCH, CFG_KW, SEQ = "whisper-small", {}, 32     # 16 frames, 32 tokens
CASES = {"whisper-1x2": dict(model=2), "whisper-2x2": dict(data=2, model=2)}


@pytest.fixture(scope="module")
def jax_mesh(tmp_path_factory):
    """JAX's own (2, 2) mesh, started before the port's ranks so that it
    runs beside them."""
    return JaxMesh(ARCH, CFG_KW, jax_run(ARCH, CFG_KW, SEQ)[0],
                   tmp_path_factory.mktemp("jax_mesh"))


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_training_matches_jax(case, tmp_path, jax_mesh):
    _, init, metrics, final, n = jax_run(ARCH, CFG_KW, SEQ)
    ranks = port_run(case, ARCH, CFG_KW, CASES[case], SEQ, tmp_path)
    check_ranks(ranks, ARCH, CFG_KW, CASES[case], init, metrics, final, n)


def test_mesh_training_matches_jax_own_2x2_mesh(tmp_path, jax_mesh):
    """The port's (2, 2) ranks against JAX's own (2, 2) mesh (GSPMD over
    four forced host devices)."""
    _, init, *_ = jax_run(ARCH, CFG_KW, SEQ)
    ranks = port_run("whisper-2x2", ARCH, CFG_KW, CASES["whisper-2x2"], SEQ,
                     tmp_path)
    metrics, final, n = jax_mesh.result()
    check_ranks(ranks, ARCH, CFG_KW, CASES["whisper-2x2"], init, metrics,
                final, n)


SPECS_CHILD = r"""
import json, sys
import jax, numpy as np
from jax.sharding import Mesh
from repro.config import get_model_config, reduce_for_smoke, ParallelConfig
from repro.models import build_model
from repro.sharding.rules import param_sharding_tree
out = {}
for shape in json.loads(sys.argv[1]):
    mesh = Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(
        shape), ("data", "model"))
    for size in ("full", "reduced"):
        cfg = get_model_config("whisper-small")
        if size == "reduced":
            cfg = reduce_for_smoke(cfg)
        tree = param_sharding_tree(build_model(cfg, ParallelConfig())
                                   .logical(), mesh)
        out[f"{size}|{tuple(shape)}"] = jax.tree.map(
            lambda s: [list(a) if isinstance(a, tuple) else a
                       for a in s.spec], tree,
            is_leaf=lambda x: hasattr(x, "spec"))
print(json.dumps(out))
"""


def test_param_specs_equal_jax():
    """EncDec's specs on (1, 2), (2, 2) and (1, 4) meshes are JAX's
    ``param_sharding_tree`` of its logical tree (JAX stacks each stack's
    layers on a leading axis, which the port's per-layer lists drop)."""
    import json
    from repro_torch.config import get_model_config, reduce_for_smoke
    from repro_torch.models import build_model
    shapes = [(1, 2), (2, 2), (1, 4)]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", SPECS_CHILD,
                          json.dumps(shapes)], env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    jax_specs = json.loads(res.stdout.strip().splitlines()[-1])

    def spec(enc, stacked=False):
        enc = tuple(tuple(a) if isinstance(a, list) else a for a in enc)
        return enc[1:] if stacked else enc

    def same(got, want, stacked):
        if isinstance(got, dict):
            assert set(got) == set(want)
            for k in got:
                same(got[k], want[k], stacked)
        else:
            assert got == spec(want, stacked), (got, want)
    for shape in shapes:
        mesh = make_mesh(shape, ("data", "model"))
        for size in ("full", "reduced"):
            cfg = get_model_config(ARCH)
            if size == "reduced":
                cfg = reduce_for_smoke(cfg)
            got = build_model(cfg, "cpu").param_specs(mesh)
            want = jax_specs[f"{size}|{shape}"]
            for key, tree in got.items():
                if key in ("enc_blocks", "dec_blocks"):
                    for layer in tree:
                        same(layer, want[key], True)
                else:
                    same(tree, want[key], False)


def test_rank_rows_split_the_frames_beside_the_tokens():
    """At (2, 2) each rank takes its batch rows of every array, its
    half of the 16 frames and of the 32 tokens; lengths
    that do not split raise, naming both."""
    b = {"enc_embeds": np.arange(4 * 16 * 2, dtype=np.float32).reshape(
        4, 16, 2), "tokens": np.arange(4 * 32).reshape(4, 32),
        "labels": np.arange(4 * 32).reshape(4, 32)}
    batch = {k: torch.from_numpy(v) for k, v in b.items()}
    for r in range(4):
        mesh = make_mesh((2, 2), ("data", "model"), r)
        d, m = mesh.coords["data"], mesh.coords["model"]
        (got,) = rank_rows(batch, mesh, 1)
        rows = slice(2 * d, 2 * d + 2)
        np.testing.assert_array_equal(got["enc_embeds"].numpy(),
                                      b["enc_embeds"][rows, 8 * m:8 * m + 8])
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k].numpy(),
                                          b[k][rows, 16 * m:16 * m + 16])
    odd = dict(batch, enc_embeds=batch["enc_embeds"][:, :15])
    with pytest.raises(ValueError, match="15 frames of enc_embeds and 32 "
                                         "tokens"):
        rank_rows(odd, make_mesh((1, 2), ("data", "model"), 1), 1)


def test_frontend_rows_take_their_global_positions():
    """A rank's frames through the adapter take the position rows at
    their global offset: the ranks' pieces make the whole input's."""
    _, cfg = configs(ARCH, CFG_KW)
    gen = torch.Generator().manual_seed(0)
    params = init_frontend(gen, cfg, torch.float32)
    x = torch.randn((2, cfg.encoder_seq, cfg.d_model), generator=gen)
    whole = apply_frontend(params, x, cfg)
    half = cfg.encoder_seq // 2
    parts = [apply_frontend(params, x[:, m * half:(m + 1) * half], cfg,
                            seq_len=cfg.encoder_seq, offset=m * half)
             for m in range(2)]
    torch.testing.assert_close(torch.cat(parts, dim=1), whole, rtol=0,
                               atol=0)
    # a whole input of another length gets no position rows, as in JAX
    short = apply_frontend(params, x[:, :half], cfg)
    torch.testing.assert_close(short, x[:, :half] @ params["adapter"])


# ---------------------------------------------------------------------------
# the launcher on the recurrent models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["xlstm-125m", "hymba-1.5b"])
def test_train_cli_on_a_2x2_mesh(arch, tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
         "--smoke", "--device", "cpu", "--steps", "2", "--batch", "4",
         "--seq", "32", "--data", "2", "--model-axis", "2", "--ckpt-dir",
         str(tmp_path)], env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "4 ranks (data=2, model=2) over gloo" in out.stdout
    assert "step     1 loss" in out.stdout and "done" in out.stdout
