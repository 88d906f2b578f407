"""The system under test: the port (``libgooey_tpu_torch``), built from a
configuration and driven block by block through its own entry points.

``engine._render_all`` renders the banks, the mix, the master gain, the
configuration's bus and the soft limiter; where the configuration has a
chain, ``mixer.chain.process_chain`` then folds the limited stereo through
it (one ``bus_chain`` launch a run).  ``engine._events_to`` uploads a chunk
of blocks' events, as ``render_many`` does."""

from __future__ import annotations

import numpy as np

from portbench.harness.spec import mix_rows


class Program:
    """The port's state and statics for one configuration on ``device``."""

    def __init__(self, cfg: dict, device):
        from libgooey_tpu_torch.core.smoother import SmootherBank, smoothing_coeff
        from libgooey_tpu_torch.engine import engine
        from libgooey_tpu_torch.mixer import chain

        self.engine, self.chain = engine, chain
        self.cfg, self.device = cfg, device
        sr = cfg["sample_rate"]
        self.sample_rate = sr
        bus = cfg.get("bus", {}).get("order", [])
        self.static = dict(
            kinds=tuple(cfg["voices"]), sample_rate=sr, block_size=cfg["block_size"],
            smooth_coeff=smoothing_coeff(sr), limiter_threshold=cfg["limiter_threshold"],
            family_static=tuple((k, tuple(sorted(v.items())))
                                for k, v in cfg.get("family_static", {}).items()),
            fx_order=tuple(bus))
        self.chain_targets = self.chain_key = self._chain = None
        self.has_chain = bool(cfg.get("chain"))
        if self.has_chain:
            self._chain = chain.EffectChain(sr, cfg["chain"]["bpm"], device=device)
            for eid in cfg["chain"]["entries"]:
                self._chain.add(eid)
            self.chain_targets = self._chain.targets_list()
            self.chain_key = self._chain.static_key()
        self._SmootherBank = SmootherBank

    def initial_state(self) -> dict:
        """Every family at the preset its configuration states (its flags at
        the family's defaults), the mixer, the bus's and the chain's effects
        at their defaults, on the card."""
        engine, dev, cfg = self.engine, self.device, self.cfg
        state = {}
        for k, v in cfg["voices"].items():
            preset = np.asarray(cfg["presets"][k]["params"], np.float32)
            state[k] = engine.FAMILIES[k].init_state(
                v, targets=np.broadcast_to(preset, (v, preset.shape[0])), device=dev)
        pan, gain, master = mix_rows(cfg)
        state["pan"] = self._SmootherBank.init(pan, dev)
        state["gain"] = self._SmootherBank.init(gain, dev)
        state["master"] = self._SmootherBank.init(master, dev)
        for name in self.static["fx_order"]:
            state["fx_" + name] = engine.FX_MODULES[name].init_state(self.sample_rate, device=dev)
        if self.has_chain:
            self._chain.reset()
            state["chain"] = list(self._chain.states)
        return state

    def upload(self, events: dict) -> dict:
        """A chunk of blocks' host events on the card (``_events_to``)."""
        return self.engine._events_to(events, self.device)

    def render(self, state: dict, events: dict):
        """``_render_all`` -> ``(state, stereo [2, B], mono [B])``."""
        return self.engine._render_all(state, events, **self.static)

    def process_chain(self, state: dict, x):
        """The limited stereo through the configuration's chain."""
        new_state = dict(state)
        new_state["chain"], y = self.chain.process_chain(
            state["chain"], x, self.chain_targets, self.chain_key, sample_rate=self.sample_rate)
        return new_state, y
