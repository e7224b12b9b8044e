"""The H100 roofline (``analysis/roofline.py``) against the JAX package's
``roofline_from_hlo_text``, on the CPU.

JAX reads its cost from compiled XLA text; the port takes the cost
record.  Fed the cost ``analyze_hlo_text`` reads from a compiled reduced
model's HLO, and with JAX's module constants set to the H100's, the port
returns JAX's dict (its ``hlo_*`` keys without the prefix), value for
value; ``render_table`` and ``lever`` read it alike.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.analysis import roofline as JR  # noqa: E402
from repro.analysis.hlo import analyze_hlo_text  # noqa: E402
from repro.config import ParallelConfig as JParallel  # noqa: E402
from repro.config import get_model_config, reduce_for_smoke  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro_torch.analysis import roofline as TR  # noqa: E402
from repro_torch.config import SHAPES  # noqa: E402
from repro_torch.config import get_model_config as t_get  # noqa: E402

RENAMED = {"hlo_flops_per_dev": "flops_per_dev",
           "hlo_bytes_per_dev": "bytes_per_dev"}


def test_h100_constants():
    assert (TR.PEAK_FLOPS, TR.HBM_BW, TR.LINK_BW) == (989e12, 3.35e12,
                                                      450e9)


@pytest.mark.parametrize("arch,shape,n_dev", [
    ("llama2-7b", "train_4k", 256), ("gemma2-2b", "decode_32k", 16),
    ("qwen3-moe-30b-a3b", "prefill_32k", 64)])
def test_roofline_terms_match_jax_on_hlo_cost(arch, shape, n_dev,
                                              monkeypatch):
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(JR, name, getattr(TR, name))
    cfg = reduce_for_smoke(get_model_config(arch))
    jm = j_build(cfg, JParallel(remat="none"))
    params = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    toks = jax.ShapeDtypeStruct((2, 16), np.int32)
    text = jax.jit(jm.apply).lower(params, toks).compile().as_text()
    want = JR.roofline_from_hlo_text(text, arch=arch, shape_name=shape,
                                     n_devices=n_dev)
    cost = analyze_hlo_text(text)
    got = TR.roofline_terms(cost, cfg=t_get(arch), shape=SHAPES[shape],
                            n_devices=n_dev)
    assert got == {RENAMED.get(k, k): v for k, v in want.items()}
    assert got["flops_per_dev"] > 0 and got["dominant"] in (
        "compute_s", "memory_s", "collective_s")
    # the port's own record type gives the same
    own = TR.Cost(flops=cost.flops, bytes=cost.bytes,
                  collective_bytes=cost.collective_bytes,
                  by_collective=cost.by_collective,
                  top_collectives=cost.top_collectives)
    assert TR.roofline_terms(own, cfg=t_get(arch), shape=SHAPES[shape],
                             n_devices=n_dev) == got
    rec = {"cell": f"{arch}/{shape}", "status": "ok", "roofline": got}
    assert TR.render_table([rec]) == JR.render_table([rec])


def test_lever_and_records(tmp_path):
    import json
    for dom in ("collective_s", "memory_s"):
        rec = {"dominant": dom, "by_collective": {"all-reduce": 3e8}}
        assert TR.lever(rec) == JR.lever(rec).replace("chip", "card")
    # compute-bound advice names the H100's tensor cores, not the MXU
    assert "wgmma" in TR.lever({"dominant": "compute_s"})
    recs = [{"cell": "a", "status": "skipped", "reason": "no mesh"},
            {"cell": "b", "status": "ok"}]
    for i, r in enumerate(recs):
        (tmp_path / f"{i}.json").write_text(json.dumps(r))
    assert TR.load_records(str(tmp_path)) == JR.load_records(str(tmp_path))
    assert TR.render_table(recs) == JR.render_table(recs)
