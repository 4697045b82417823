"""Declarative interaction registry (port of concept_tpu/forces/registry.py;
reference src/interactions.py:2456-2827, find_interactions + register).

Forces are registered with their implemented methods and which of them
hold a long-range (potential) or a short-range (pairwise) part; each
step the registry scans the components' ``forces`` selections into the
ordered list of (force, method, receivers, suppliers) to execute.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ForceSpec:
    name: str
    methods: tuple  # implemented methods, e.g. ('pm', 'p3m', 'pp', 'ppnonperiodic')
    deterministic: bool = True
    instantaneous: bool = False
    longrange_methods: tuple = ()
    shortrange_methods: tuple = ()


_REGISTRY: dict[str, ForceSpec] = {}


def register(name: str, methods, longrange_methods=(), shortrange_methods=(),
             deterministic: bool = True, instantaneous: bool = False):
    _REGISTRY[name] = ForceSpec(
        name=name, methods=tuple(methods),
        longrange_methods=tuple(longrange_methods),
        shortrange_methods=tuple(shortrange_methods),
        deterministic=deterministic, instantaneous=instantaneous,
    )


def get(name: str) -> ForceSpec:
    return _REGISTRY[name]


def registered() -> dict:
    return dict(_REGISTRY)


# built-in forces (reference registrations: gravity interactions.py:2837,
# lapse interactions.py:2964)
register("gravity", methods=("pm", "p3m", "pp", "ppnonperiodic"),
         longrange_methods=("pm", "p3m"),
         shortrange_methods=("p3m", "pp", "ppnonperiodic"))
register("lapse", methods=("pm",), longrange_methods=("pm",))


def find_interactions(specs, interaction_type: str = "any"):
    """Component specs → ordered [(force, method, receivers, suppliers)].

    interaction_type: 'any' | 'long-range' | 'short-range'.  The
    components sharing a (force, method) form one group, each of them
    both receiver and supplier; groups come sorted by (force, method)."""
    groups: dict = {}
    for spec in specs:
        for force, method in getattr(spec, "forces", ()) or ():
            fs = _REGISTRY.get(force)
            if fs is None:
                raise KeyError(f"force {force!r} is not registered")
            if method not in fs.methods:
                raise ValueError(f"force {force!r} has no method {method!r} "
                                 f"(available: {fs.methods})")
            if interaction_type == "long-range" and method not in fs.longrange_methods:
                continue
            if interaction_type == "short-range" and method not in fs.shortrange_methods:
                continue
            groups.setdefault((force, method), []).append(spec)
    return [(force, method, comps, comps)
            for (force, method), comps in sorted(groups.items(), key=lambda kv: kv[0])]
