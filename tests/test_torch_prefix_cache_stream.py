"""The schedule of ``chip_smoke.py``'s prefix phase (16 requests behind
a 256-token system prompt, 8 slots, 256 blocks of 16), which does not
depend on the model's values, run at reduced width: its prefix hits,
evictions and CoW splits, cold and warm. deepseek-v3's stream gets no
cold hit in the JAX engine either: the allocator reissues the lowest
free block id first, cached or not, so an incumbent's growth takes the
system prompt's root page as soon as its last holder retires. (Split
from ``test_torch_prefix_cache.py`` so that its long deepseek-v3 case
runs on another test worker.)
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs.registry import ASSIGNED  # noqa: E402
from repro.models.api import build_model as jbuild  # noqa: E402
from repro.runtime.engine import ServingEngine as JaxEngine  # noqa: E402
from repro.runtime.request import Request as JaxRequest  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.runtime.engine import ServingEngine  # noqa: E402
from repro_torch.runtime.request import Request  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: beside other test workers an intra-op pool a
    process slows the eager serve many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# arch -> (cold hits, cold hit tokens, warm hits, warm hit tokens, warm
# CoW splits) of chip_smoke.py's prefix streams (seed 0).
CHIP_STREAM = {"qwen3-0.6b": (8, 2048, 16, 4799, 1),
               "deepseek-v3-671b": (0, 0, 16, 4846, 2)}


@pytest.mark.parametrize("arch", sorted(CHIP_STREAM))
def test_chip_stream_schedule(arch):
    """The full-width stream's request lengths (token ids folded into the
    reduced vocabulary) through the reduced model: the counts the card's
    run must show. For deepseek-v3 the JAX engine's cold run is held to
    the same 0 hits and evictions."""
    args = types.SimpleNamespace(prompt_len=128, gen=32, requests=16,
                                 temperature=0.0, shared_prefix=256,
                                 arrival="back2back", rate=8.0)
    stream = tserve.build_stream(get_config(arch), args,
                                 np.random.RandomState(0))
    cfg = get_config(arch).reduced()
    toks = [np.asarray(r.tokens) % cfg.vocab_size for r in stream]
    arena = dict(num_slots=8, max_seq=416, chunk_size=8, block_size=16,
                 num_blocks=256, prefix_cache=True)
    model = build_model(cfg)
    eng = ServingEngine(model, model.init(torch.Generator().manual_seed(0)),
                        device="cpu", **arena)
    mk = lambda cls: [cls(rid=i, tokens=t, max_new_tokens=args.gen)  # noqa
                      for i, t in enumerate(toks)]
    cold = eng.serve(mk(Request), seed=0, realtime=False)
    evictions = eng.arena.prefix_cache.evictions
    warm = eng.serve(mk(Request), seed=0, realtime=False)
    assert (cold.stats.prefix_hits, cold.stats.prefix_hit_tokens,
            warm.stats.prefix_hits, warm.stats.prefix_hit_tokens,
            warm.stats.cow_splits) == CHIP_STREAM[arch]
    if CHIP_STREAM[arch][0] == 0:
        jcfg = ASSIGNED[arch].reduced()
        jmodel = jbuild(jcfg)
        jeng = JaxEngine(jmodel, jmodel.init(jax.random.PRNGKey(0)),
                         paged_attn="ref", **arena)
        jcold = jeng.serve(mk(JaxRequest), seed=0, realtime=False)
        assert jcold.stats.prefix_hits == 0
        assert jeng.arena.prefix_cache.evictions == evictions > 0
