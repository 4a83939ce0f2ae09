"""The port's last two examples against the reference's, on the CPU:
``examples/bet_lm_training.py`` (the three schedules on a reduced LM,
one RunSpec sweep) and ``examples/serve_decode.py`` (prefill and greedy
decode with a sliding-window cache).  Each prints the reference's
columns; the schedules' step counts, simulated times and loaded
examples are the reference's, and the greedy tokens, from the
reference's weights and prompts in float32, are the reference's."""
import contextlib
import io
import pathlib
import re
import runpy
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch import convert

pytestmark = pytest.mark.tier1

ROOT = pathlib.Path(__file__).resolve().parents[1]
# a small corpus, short sequences, few steps: still two stages and a race
SMALL = ["--corpus", "128", "--seq-len", "16", "--batch-size", "2",
         "--final-steps", "2", "--steps-per-stage", "1"]


def _lines(run) -> list:
    out = io.StringIO()
    with contextlib.redirect_stdout(out), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        run()
    return out.getvalue().splitlines()


def _reference(script: str, argv: list) -> list:
    saved = sys.argv
    sys.argv = [script] + argv
    try:
        return _lines(lambda: runpy.run_path(str(ROOT / "examples" / script),
                                             run_name="__main__"))
    finally:
        sys.argv = saved


def _fields(line: str) -> dict:
    return dict(re.findall(r"(\w+)=\s*(\S+)", line))


def test_bet_lm_training_prints_the_reference_columns():
    from repro_torch.examples import bet_lm_training
    torch.set_num_threads(1)
    ref = _reference("bet_lm_training.py", SMALL)
    port = _lines(lambda: bet_lm_training.main(SMALL + ["--device", "cpu"]))
    assert len(port) == len(ref) == 5
    assert port[0] == ref[0]                 # arch=... params≈...M (active)
    for p, r in zip(port[1:4], ref[1:4]):
        assert p.split()[0] == r.split()[0]  # bet, two_track, batch
        pf, rf = _fields(p), _fields(r)
        assert list(pf) == list(rf)
        for k in ("steps", "sim_time", "loaded"):
            assert pf[k] == rf[k], (p, r)
        assert np.isfinite(float(pf["final_eval_loss"]))
    assert port[4].split("already")[0] == ref[4].split("already")[0]


def test_serve_decode_greedy_tokens_are_the_references():
    """The reference's weights (key 0) and prompts (key 1) at its demo's
    shapes, in float32: the port's ``run`` decodes the same tokens, and
    its lines are the reference's but for the timing."""
    from repro_torch.examples import serve_decode
    arch, window, B, S, gen = "internlm2-1.8b", 32, 4, 48, 16
    jcfg = jconfigs.reduced(jconfigs.get(arch)).with_(
        sliding_window=window, dtype=jnp.float32)
    tcfg = tconfigs.reduced(tconfigs.get(arch)).with_(
        sliding_window=window, dtype=torch.float32)
    jp = JT.init_params(jcfg, jax.random.key(0))
    prompts = jax.random.randint(jax.random.key(1), (B, S), 0,
                                 max(2, jcfg.vocab_size), dtype=jnp.int32)
    want = np.asarray(jserve.generate(jcfg, jp, prompts, gen_tokens=gen))
    tp = convert.params_from_jax(jax.device_get(jp), device="cpu")
    got = []
    lines = _lines(lambda: got.append(serve_decode.run(
        tcfg, tp, torch.from_numpy(np.asarray(prompts)), gen, window)))
    np.testing.assert_array_equal(got[0].numpy(), want)
    ref = _reference("serve_decode.py", [])
    assert len(lines) == len(ref) == 2
    assert lines[0] == ref[0]
    assert lines[1].split(" in ")[0] == ref[1].split(" in ")[0]
    port = _lines(lambda: serve_decode.main(["--device", "cpu"]))
    assert port[0] == ref[0] and port[1].split(" in ")[0] == \
        ref[1].split(" in ")[0]
