"""xLSTM in bf16 against the same weights in fp32, the JAX package beside the
port, on the CPU: the readings behind ``chip_smoke.py``'s XLSTM_BF16_TOL.

The port's bf16 xLSTM cannot be held to its fp32 run at an fp32 tolerance:
both packages round the residual stream and every projection to bf16, and
24 exponentially gated layers carry that rounding to the logits. This
script measures how far it goes in the JAX package itself (the lower
reading of the limit), the port's own drift on the same weights, and a
control the limit must refuse (the upper reading): one decode step from a
zeroed state, as if the prefill's captured state were dropped.

The weights are drawn with numpy (``torch_refs.jax_params``) and rounded
to bf16, so both dtypes of both packages run the same values; the model is
xLSTM-350M's layer pattern and depth at a narrower width (full width is not
run on the CPU). JAX's decode step returns no logits, so its "decode"
reading is the prefill of the prompt and the decoded token (the same
recurrence one token further); the port's is its decode step.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/xlstm_drift.py \
        [--layers 24] [--prompt 256] [--d-model 256] [--seeds 3]

Prints one line per seed and reading: norm-wise relative distances
``||a - b|| / ||b||`` of the last position's logits over the real vocab.
"""
import argparse
import dataclasses
import os
import sys

import numpy as np
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.configs.base import InputShape as JShape  # noqa: E402
from repro.core import execution as jexec  # noqa: E402
from repro.core import strategy as jstrategy  # noqa: E402
from repro.launch.mesh import make_smoke_mesh  # noqa: E402
from repro.models.transformer import build_model as jbuild_model  # noqa: E402
from repro_torch.checkpoint.convert import from_jax_params  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.core import execution, strategy  # noqa: E402
from repro_torch.launch.serve import SERVE_GEOMETRY  # noqa: E402
from repro_torch.models.transformer import build_model  # noqa: E402
from torch_refs import jax_params, jit_quick  # noqa: E402

NAME = "xlstm-350m"
SIZES1, SIZES4 = {"data": 1, "model": 1}, {"data": 1, "model": 4}


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def drift(layers: int, prompt: int, d_model: int, seed: int) -> dict:
    """The readings for one draw of weights and prompt (``seed``)."""
    over = dict(num_layers=layers, d_model=d_model, head_dim=d_model // 4)
    jcfg = dataclasses.replace(jget_arch(NAME), **over)
    cfg = dataclasses.replace(get_arch(NAME), **over)
    geom = SERVE_GEOMETRY[NAME]
    jm1 = jbuild_model(jcfg, SIZES1, dtype=jnp.float32)
    jm4 = jbuild_model(jcfg, SIZES4, dtype=jnp.float32, **geom)
    jp1, np4 = jax_params(jm1, jm4, seed=seed)

    def bf16_values(a):
        return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))

    jp1 = jax.tree.map(lambda a: jnp.asarray(bf16_values(a)), jp1)
    np4 = jax.tree.map(bf16_values, np4)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, prompt + 1)  # the prompt, then the decoded token
    v, mesh = cfg.vocab_size, make_smoke_mesh()

    def jax_logits(dt):
        jm = jbuild_model(jcfg, SIZES1, dtype=dt)
        p = jax.tree.map(lambda a: a.astype(dt), jp1)
        out = []
        for n in (prompt, prompt + 1):
            xp = jstrategy.make_execution_plan(jm, JShape("p", n, 1, "prefill"), SIZES1)
            step = jit_quick(jexec.make_step_fn(jm, xp, mesh))
            res = step(p, {"tokens": jnp.asarray(tokens[None, :n], jnp.int32)})
            out.append(np.asarray(res["last_logits"][0, :v], np.float64))
        return out

    def port_logits(dt):
        m = build_model(cfg, SIZES4, dtype=dt, device="cpu", **geom)
        params = from_jax_params(np4, m)
        cache = prompt + 8
        xp = strategy.make_execution_plan(m, InputShape("p", prompt, 1, "prefill"), SIZES4)
        pre = execution.forward_prefill(params, torch.as_tensor(tokens[None, :prompt]),
                                        execution.Ctx(model=m, xp=xp, capture_len=cache))
        xpd = strategy.make_execution_plan(m, InputShape("g", cache, 1, "decode"), SIZES4)
        tok = torch.as_tensor(tokens[None, prompt:])

        def decode(state):
            out = execution.forward_decode(params, tok, state, execution.Ctx(model=m, xp=xpd))
            return out["logits"][0, :v].double().numpy()

        state = pre["state"]
        zeroed = {**state, "layers": jax.tree.map(torch.zeros_like, state["layers"])}
        return [pre["last_logits"][0, :v].double().numpy(), decode(state), decode(zeroed)]

    j32, j16 = jax_logits(jnp.float32), jax_logits(jnp.bfloat16)
    p32, p16 = port_logits(torch.float32), port_logits(torch.bfloat16)
    out = {}
    for i, step in enumerate(("prefill", "decode")):
        out[step] = {"jax_bf16_vs_fp32": rel(j16[i], j32[i]),
                     "port_bf16_vs_fp32": rel(p16[i], p32[i]),
                     "port_bf16_vs_jax_bf16": rel(p16[i], j16[i]),
                     "port_fp32_vs_jax_fp32": rel(p32[i], j32[i])}
    out["decode"]["control_zeroed_state_bf16_vs_fp32"] = rel(p16[2], p32[1])
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=24)
    ap.add_argument("--prompt", type=int, default=256)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--seeds", type=int, default=3)
    args = ap.parse_args()
    torch.set_num_threads(4)
    print(f"xLSTM-350M's pattern, {args.layers} layers, d_model {args.d_model}, "
          f"{args.prompt}-token prompts; norm-wise relative distances of the logits")
    for seed in range(args.seeds):
        for step, row in drift(args.layers, args.prompt, args.d_model, seed).items():
            print(f"seed {seed} {step}: " + " ".join(f"{k} {x:.4e}" for k, x in row.items()))


if __name__ == "__main__":
    main()
