"""A tiny line-based DSL for describing Engine programs (port of
libgooey_tpu/dsl.py).

Behavioral reference: src/dsl.rs (969 LoC) — statements build an Engine:

    bpm 120
    master 0.25
    inst kick kick tight
    inst hat hihat closed_tight
    seq kick x...x...x...x...
    seq hat 9.5.|9.5.|9.5.|9.5.
    lfo 1bar kick.frequency amt=0.5
    fx lowpass 2000 0.3

Lines are statements; ``#`` starts a comment.  Pattern strings use ``x``
(full velocity), digits 1-9 (velocity/9), ``.`` for rests, ``|`` as a bar
separator.  Host code: parses into a Program and builds the port's Engine,
on a CUDA card unless the caller asks for ``device="cpu"`` (with no card
it raises, as the Engine does).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from libgooey_tpu_torch.engine.engine import FAMILIES, Engine

#: LFO timing names → MusicalDivision index (engine/lfo.rs:46-60)
DIVISIONS = {
    "4bar": 0, "4bars": 0, "2bar": 1, "2bars": 1, "bar": 2, "1bar": 2,
    "half": 3, "1/2": 3, "quarter": 4, "1/4": 4, "eighth": 5, "1/8": 5,
    "sixteenth": 6, "1/16": 6, "thirtysecond": 7, "1/32": 7,
}

#: preset-name aliases per family (dsl.rs:345-430 accepts several spellings)
PRESET_ALIASES = {
    "kick": {"dirty": "dirt"},
    "snare": {},
    "hihat": {"closed": "closed_default", "open": "open_default",
              "short": "closed_tight", "tight": "closed_tight",
              "dark": "closed_dark", "long": "open_long",
              "bright": "open_bright"},
    "hihat2": {"closed": "short", "closed_default": "short",
               "closed_tight": "short", "open": "loose",
               "open_default": "loose", "open_long": "loose"},
    "tom": {"mid_tom": "mid", "high_tom": "high", "low_tom": "low",
            "floor_tom": "floor"},
    "tom2": {},
    "bass": {},
    "poly": {},
}

#: LFO-target parameter aliases (dsl.rs:669-699 resolve_parameter_alias)
PARAM_ALIASES = {
    "kick": {"pitch_drop": "tuning", "pitch_env_amt": "tuning",
             "pitch_env_crv": "tuning", "pitch_ratio": "tuning",
             "tuning_offset": "tuning", "osc_decay": "oscillator_decay",
             "phase_mod_amt": "phase_mod_amount",
             "noise_res": "noise_resonance"},
}

#: instrument family aliases (dsl.rs inst statement)
FAMILY_ALIASES = {
    "kick": "kick", "snare": "snare", "hihat": "hihat", "hat": "hihat",
    "hihat2": "hihat2", "tom": "tom", "tom2": "tom2", "bass": "bass",
    "poly": "poly",
}

FX_NAMES = {"lowpass", "filter", "delay", "saturation", "tilt", "spring",
            "reverb", "plate", "compressor", "clear", "limiter"}
FX_CANONICAL = {"filter": "lowpass", "reverb": "spring"}


@dataclass
class InstrumentDef:
    name: str
    family: str
    preset: Optional[str]


@dataclass
class SequencerDef:
    instrument: str
    pattern: str
    swing: Optional[float] = None


@dataclass
class LfoDef:
    division: int
    instrument: str
    parameter: str
    amount: float = 1.0


@dataclass
class EffectDef:
    name: str
    args: List[float] = field(default_factory=list)


@dataclass
class Program:
    bpm: Optional[float] = None
    master_gain: Optional[float] = None
    instruments: List[InstrumentDef] = field(default_factory=list)
    sequencers: List[SequencerDef] = field(default_factory=list)
    lfos: List[LfoDef] = field(default_factory=list)
    effects: List[EffectDef] = field(default_factory=list)

    @staticmethod
    def parse(source: str) -> "Program":
        prog = Program()
        names = set()
        for lineno, raw in enumerate(source.splitlines(), 1):
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            head = parts[0].lower()

            def err(msg):
                raise ValueError(f"line {lineno}: {msg} — {raw.strip()!r}")

            if head == "bpm":
                if len(parts) != 2:
                    err("bpm takes one value")
                prog.bpm = float(parts[1])
            elif head == "master":
                prog.master_gain = float(parts[1])
            elif head == "inst":
                if len(parts) < 3:
                    err("inst needs: inst <name> <family> [preset]")
                name, fam = parts[1], parts[2].lower()
                if fam not in FAMILY_ALIASES:
                    err(f"unknown instrument family {fam!r}")
                if name in names:
                    err(f"duplicate instrument name {name!r}")
                names.add(name)
                preset = parts[3] if len(parts) > 3 else None
                prog.instruments.append(InstrumentDef(name, FAMILY_ALIASES[fam], preset))
            elif head == "seq":
                if len(parts) < 3:
                    err("seq needs: seq <inst> <pattern> [swing=X]")
                if parts[1] not in names:
                    err(f"sequencer targets unknown instrument {parts[1]!r}")
                swing = None
                for p in parts[3:]:
                    if p.startswith("swing="):
                        swing = float(p.split("=", 1)[1])
                prog.sequencers.append(SequencerDef(parts[1], parts[2], swing))
            elif head == "lfo":
                if len(parts) < 3 or "." not in parts[2]:
                    err("lfo needs: lfo <division> <inst>.<param> [amt=X]")
                div = parts[1].lower()
                if div not in DIVISIONS:
                    err(f"unknown LFO division {div!r}")
                inst, param = parts[2].split(".", 1)
                if inst not in names:
                    err(f"lfo targets unknown instrument {inst!r}")
                amount = 1.0
                for p in parts[3:]:
                    if p.startswith(("amt=", "amount=")):
                        amount = float(p.split("=", 1)[1])
                prog.lfos.append(LfoDef(DIVISIONS[div], inst, param, amount))
            elif head == "fx":
                if len(parts) < 2:
                    err("fx needs: fx <effect> [args...]")
                fxn = parts[1].lower()
                if fxn not in FX_NAMES:
                    err(f"unknown effect {fxn!r}")
                prog.effects.append(
                    EffectDef(FX_CANONICAL.get(fxn, fxn),
                              [float(p) for p in parts[2:]])
                )
            else:
                err(f"unknown statement {head!r}")
        return prog

    def build_engine(self, sample_rate: float = 44100.0, *, device="cuda") -> Engine:
        """Build an Engine on ``device`` from the parsed program (dsl.rs
        build_engine)."""
        engine = Engine(sample_rate, device=device)
        bpm = self.bpm if self.bpm is not None else 120.0
        for idef in self.instruments:
            mod = FAMILIES[idef.family]
            cfg = None
            if idef.preset is not None:
                presets = mod.PRESETS
                name_p = PRESET_ALIASES.get(idef.family, {}).get(
                    idef.preset.lower(), idef.preset.lower()
                )
                if name_p not in presets:
                    raise ValueError(
                        f"unknown preset {idef.preset!r} for {idef.family}"
                    )
                cfg = presets[name_p]()
            engine.add_instrument(idef.name, idef.family, cfg)
        for sdef in self.sequencers:
            steps = len(sdef.pattern.replace("|", "")) or 16
            seq = engine.new_sequencer(sdef.instrument, bpm, steps)
            seq.set_pattern_string(sdef.pattern)
            if sdef.swing is not None:
                seq.set_swing(sdef.swing)
                seq.swing.current = seq.swing.target
            seq.start()
        fam_by_name = {i.name: i.family for i in self.instruments}
        for i, ldef in enumerate(self.lfos[:8]):
            engine.set_lfo(i, division=ldef.division, bpm=bpm, amount=ldef.amount)
            fam = fam_by_name.get(ldef.instrument)
            param = PARAM_ALIASES.get(fam, {}).get(ldef.parameter, ldef.parameter)
            engine.add_lfo_route(i, ldef.instrument, param)
        for edef in self.effects:
            name = edef.name
            args = edef.args
            if name == "clear":
                engine.fx_order = []
                if engine._state is not None:
                    engine._state = None
                continue
            if name == "limiter":
                engine.limiter_threshold = args[0] if args else 1.0
                continue
            if name == "lowpass":
                engine.add_global_effect("lowpass", [
                    args[0] if args else 8000.0, args[1] if len(args) > 1 else 0.2,
                ])
            elif name == "delay":
                engine.add_global_effect("delay", [
                    args[0] if args else 0.5, args[1] if len(args) > 1 else 0.3,
                    args[2] if len(args) > 2 else 0.3,
                    args[3] if len(args) > 3 else 8000.0,
                ])
            elif name == "saturation":
                engine.add_global_effect("saturation", [
                    args[0] if args else 0.3, args[1] if len(args) > 1 else 0.3, 1.0,
                ])
            elif name == "tilt":
                engine.add_global_effect("tilt", [
                    args[0] if args else 0.5, args[1] if len(args) > 1 else 0.0,
                ])
            elif name == "spring":
                engine.add_global_effect("spring", [
                    args[0] if args else 0.5, args[1] if len(args) > 1 else 0.3,
                    args[2] if len(args) > 2 else 0.5,
                ])
            elif name == "plate":
                engine.add_global_effect("plate", [
                    args[0] if args else 0.5, args[1] if len(args) > 1 else 0.3,
                    args[2] if len(args) > 2 else 0.5, 0.0, 1.0, 0.5,
                ])
            elif name == "compressor":
                engine.add_global_effect("compressor", [
                    args[0] if args else -20.0, args[1] if len(args) > 1 else 4.0,
                    args[2] if len(args) > 2 else 10.0,
                    args[3] if len(args) > 3 else 100.0, 1.0,
                ])
        if self.master_gain is not None:
            engine.set_master_gain(self.master_gain)
        return engine


def parse(source: str) -> Program:
    return Program.parse(source)


def build_engine(source: str, sample_rate: float = 44100.0, *, device="cuda") -> Engine:
    return Program.parse(source).build_engine(sample_rate, device=device)
