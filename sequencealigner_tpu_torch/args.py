# Copy of sequencealigner_tpu/args.py: only imports and source paths differ (dedupe: ROADMAP A15).
"""Decentralized three-phase CLI argument framework.

A Python rebuild of the distinctive features of the reference's clix args.h
(reference third_party/clix/args.h): modules declare their flags next to
their code via a registry; processing happens in three explicit phases —
``parse`` (scan + per-flag parse callbacks) → ``validate`` (required checks
with conflict exemption, validator callbacks ordered by an explicit cross-flag
DAG, args.h:1839-1860) → ``actions`` (ordered configuration printout);
declarative DEPENDS / CONFLICTS relations; required-unless-conflicted
semantics; grouped auto-generated help.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Callable


class ArgError(Exception):
    pass


IF_SET = "if_set"
ALWAYS = "always"


@dataclasses.dataclass
class Argument:
    name: str
    opt: str  # short flag, e.g. "a"
    lopt: str  # long flag, e.g. "align"
    help: str = ""
    param: str | None = None  # metavar; None = boolean flag
    required: bool = False
    parse: Callable[[str], object] | None = None  # str -> value (raises ArgError)
    validate: Callable[[], None] | None = None  # raises ArgError
    validate_phase: str = IF_SET
    action: Callable[[], None] | None = None  # config printout
    action_phase: str = ALWAYS
    after: tuple[str, ...] = ()  # action/help ordering DAG
    validate_after: tuple[str, ...] | None = None  # validate DAG; None = ``after``
    depends: tuple[str, ...] = ()
    conflicts: tuple[str, ...] = ()
    # runtime state
    is_set: bool = False
    value: object = None


class Registry:
    def __init__(self):
        self.args: dict[str, Argument] = {}
        self.order: list[str] = []

    def register(self, arg: Argument) -> Argument:
        if arg.name in self.args:
            raise ValueError(f"duplicate argument {arg.name}")
        self.args[arg.name] = arg
        self.order.append(arg.name)
        return arg

    def _toposort(self, phase: str = "action") -> list[Argument]:
        """Deterministic cross-module ordering: registration order refined by
        the explicit ``after`` DAG (the ARG_ORDER_AFTER mechanism)."""

        def deps(a: Argument) -> tuple[str, ...]:
            if phase == "validate" and a.validate_after is not None:
                return a.validate_after
            return a.after

        placed: list[str] = []
        remaining = list(self.order)
        while remaining:
            progressed = False
            for name in list(remaining):
                if all(d in placed or d not in self.args for d in deps(self.args[name])):
                    placed.append(name)
                    remaining.remove(name)
                    progressed = True
            if not progressed:  # cycle: fall back to registration order
                placed.extend(remaining)
                break
        return [self.args[n] for n in placed]

    # ---- phase 1: parse -------------------------------------------------
    def parse(self, argv: list[str]) -> None:
        i = 0
        by_short = {a.opt: a for a in self.args.values() if a.opt}
        by_long = {a.lopt: a for a in self.args.values() if a.lopt}
        while i < len(argv):
            tok = argv[i]
            val = None
            if tok.startswith("--"):
                body = tok[2:]
                if "=" in body:
                    body, val = body.split("=", 1)
                arg = by_long.get(body)
                if arg is None:
                    raise ArgError(f"Unknown option --{body}")
                i += 1
            elif tok.startswith("-") and len(tok) >= 2:
                arg = by_short.get(tok[1])
                if arg is None:
                    raise ArgError(f"Unknown option {tok}")
                if len(tok) > 2:  # -p4 style attached value
                    val = tok[2:]
                i += 1
            else:
                raise ArgError(f"Unexpected argument: {tok}")

            if arg.param is not None and val is None:
                if i >= len(argv):
                    raise ArgError(f"Option -{arg.opt}, --{arg.lopt} requires a value")
                val = argv[i]
                i += 1
            if arg.param is None:
                arg.value = True
            elif arg.parse is not None:
                arg.value = arg.parse(val)
            else:
                arg.value = val
            arg.is_set = True

    # ---- phase 2: validate ----------------------------------------------
    def validate(self) -> None:
        for a in self.args.values():
            if not a.is_set:
                continue
            for other in a.depends:
                if not self.args[other].is_set:
                    raise ArgError(
                        f"Option -{a.opt}, --{a.lopt} requires -{self.args[other].opt}, "
                        f"--{self.args[other].lopt}"
                    )
            for other in a.conflicts:
                if self.args[other].is_set:
                    raise ArgError(
                        f"Option -{a.opt}, --{a.lopt} conflicts with "
                        f"-{self.args[other].opt}, --{self.args[other].lopt}"
                    )
        # required-unless-conflicted (args.h:1850-1860): a required flag may be
        # omitted when a flag it conflicts with (either direction) is set.
        for a in self.args.values():
            if not a.required or a.is_set:
                continue
            exempt = any(
                (self.args[o].is_set and a.name in self.args[o].conflicts)
                for o in self.args
            ) or any(self.args[o].is_set for o in a.conflicts)
            if not exempt:
                raise ArgError(f"Missing required option -{a.opt}, --{a.lopt}")
        for a in self._toposort("validate"):
            if a.validate and (a.validate_phase == ALWAYS or a.is_set):
                a.validate()

    # ---- phase 3: actions ------------------------------------------------
    def actions(self) -> None:
        for a in self._toposort():
            if a.action and (a.action_phase == ALWAYS or a.is_set):
                a.action()

    # ---- help ------------------------------------------------------------
    def help_text(self, prog: str) -> str:
        """Grouped help in the reference's format (args_help_print,
        third_party/clix/args.h:2023-2049): required options first, then
        optional, flags column-aligned with descriptions beside them."""

        def flag_of(a: Argument) -> str:
            f = f"-{a.opt}, --{a.lopt}"
            if a.param:
                f += f" {a.param}"
            return f

        ordered = self._toposort()
        width = max(len(flag_of(a)) for a in ordered) + 2
        lines = [f"Usage: {prog} [OPTIONS]"]
        for title, want_req in (("Required options:", True),
                                ("Optional options:", False)):
            group = [a for a in ordered if a.required is want_req]
            if not group:
                continue
            lines += ["", title]
            for a in group:
                hls = a.help.splitlines() or [""]
                lines.append(f"  {flag_of(a):<{width}}{hls[0]}".rstrip())
                lines += [f"  {'':<{width}}{hl}" for hl in hls[1:]]
        return "\n".join(lines) + "\n"


def typed_parser(conv: Callable[[str], object], check, message: str):
    """Parser-generator in the spirit of ARG_PARSE_L/UL/F."""

    def parse(s: str):
        try:
            v = conv(s)
        except ValueError:
            raise ArgError(message)
        if check is not None and not check(v):
            raise ArgError(message)
        return v

    return parse
