"""The port's continuous-batching engine (``repro_torch.serve.engine``)
against the JAX reference's, token for token.

The case is ``tests/test_systems.py``'s: reduced tinyllama, 3 slots,
``max_len`` 64, 5 requests of 3-token prompts, ``max_new`` 5, here in f32
on both sides with the reference's weights (``bundle.init(PRNGKey(0))``)
handed over through ``lm_params_from_numpy``; the same for reduced
granite-moe-3b-a800m. The reference's engine
never prefills and decodes every slot at one shared position (ROADMAP
Queue 3); the port keeps that, and the last tests show it in both.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig as JShape
from repro.configs.base import get_arch as j_get_arch
from repro.launch.mesh import make_host_mesh
from repro.models import api as japi
from repro.serve import engine as jeng
from repro_torch.configs.base import get_arch
from repro_torch.kernels import ops
from repro_torch.models import api as tapi
from repro_torch.models.interop import lm_params_from_numpy
from repro_torch.serve import engine as teng


@pytest.fixture(scope="module")
def pair():
    """(JAX bundle, params; port bundle, params) of reduced tinyllama in
    f32 with the same weights."""
    jb = japi.build(j_get_arch("tinyllama-1.1b").reduced(), make_host_mesh(),
                    JShape("serve", 64, 3, "decode"), dtype=jnp.float32)
    jp = jb.init(jax.random.PRNGKey(0))
    tb = tapi.build(get_arch("tinyllama-1.1b").reduced(), device="cpu",
                    dtype=torch.float32)
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jb, jp, tb, tp


@pytest.fixture(scope="module")
def moe_pair():
    """The same for reduced granite-moe-3b-a800m (4 experts top-2; the
    router f32, as the reference keeps it)."""
    arch = "granite-moe-3b-a800m"
    jb = japi.build(j_get_arch(arch).reduced(), make_host_mesh(),
                    JShape("serve", 64, 3, "decode"), dtype=jnp.float32)
    jp = jb.init(jax.random.PRNGKey(0))
    tb = tapi.build(get_arch(arch).reduced(), device="cpu",
                    dtype=torch.float32)
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jb, jp, tb, tp


def _run(mod, bundle, params, prompts, *, slots=3, max_len=64, max_new=5):
    eng = mod.ServingEngine(bundle, params, slots=slots, max_len=max_len)
    reqs = [mod.Request(rid=i, prompt=list(p), max_new=max_new)
            for i, p in enumerate(prompts)]
    return eng.run(reqs, max_steps=64), eng


def test_engine_tokens_equal_the_reference(pair):
    jb, jp, tb, tp = pair
    prompts = [[1 + i, 2 + i, 3 + i] for i in range(5)]   # 5 > 3 slots
    want, _ = _run(jeng, jb, jp, prompts)
    ops.reset_launch_counts()
    got, eng = _run(teng, tb, tp, prompts)
    assert got == want
    assert set(got) == {0, 1, 2, 3, 4}
    for toks in got.values():
        assert len(toks) == 5 and all(0 <= t < 256 for t in toks)
    assert all(a is None for a in eng.active)
    assert sum(ops.launch_counts().values()) == 0        # CPU: no kernel


def test_engine_tokens_equal_the_reference_mixed_lengths(pair):
    """Prompts of different lengths, more requests than slots twice over,
    and a slot reused after it was freed."""
    jb, jp, tb, tp = pair
    prompts = [[7], [3, 9, 27, 81, 243], [5, 10], [200, 100, 50, 25],
               [11, 12, 13], [42] * 6, [8, 6]]
    want, _ = _run(jeng, jb, jp, prompts, max_new=4)
    got, _ = _run(teng, tb, tp, prompts, max_new=4)
    assert got == want


def test_engine_tokens_equal_the_reference_moe(moe_pair):
    """The MoE family through the engine: every decode step routes each
    slot's token through the experts (einsum dispatch, one token a group)."""
    jb, jp, tb, tp = moe_pair
    prompts = [[1 + i, 2 + i, 3 + i] for i in range(5)]
    want, _ = _run(jeng, jb, jp, prompts)
    got, _ = _run(teng, tb, tp, prompts)
    assert got == want
    assert all(len(t) == 5 for t in got.values())


def test_engine_ignores_all_but_the_last_prompt_token(pair):
    """Nothing prefills: prompts that end in the same token give the same
    output, in the reference and in the port."""
    jb, jp, tb, tp = pair
    prompts = [[5, 6, 7, 9], [100, 200, 31, 9]]
    for mod, b, p in ((jeng, jb, jp), (teng, tb, tp)):
        a, _ = _run(mod, b, p, prompts[:1], slots=1)
        c, _ = _run(mod, b, p, prompts[1:], slots=1)
        assert a[0] == c[0]


def test_engine_slots_share_one_cache_row_per_step(pair):
    """Every slot writes the KV row max(lengths) - 1, whatever its own
    length; a freed slot's rows stay as they were."""
    _, _, tb, tp = pair
    eng = teng.ServingEngine(tb, tp, slots=2, max_len=16)
    eng.admit(teng.Request(rid=0, prompt=[1, 2], max_new=1))
    eng.admit(teng.Request(rid=1, prompt=[3, 4, 5, 6, 7], max_new=3))
    eng.step()
    rows = eng.state.k[0].abs().sum(dim=(2, 3))           # [slots, T]
    assert torch.equal(rows.nonzero()[:, 1], torch.tensor([4, 4]))
    assert eng.active[0] is None                          # rid 0 done
    eng.admit(teng.Request(rid=2, prompt=[9], max_new=1))
    eng.step()                                            # writes row 5
    rows = eng.state.k[0].abs().sum(dim=(2, 3))
    assert bool(rows[0, 4] > 0) and bool(rows[0, 5] > 0)  # stale row 4 kept
    assert not bool(rows[0, :4].any())


def test_serve_example_on_cpu():
    from repro_torch.examples import serve_lm
    done = serve_lm.main(["--device", "cpu"])
    assert sorted(done) == list(range(7))
    assert all(len(t) == 12 and all(0 <= x < 256 for x in t)
               for t in done.values())
