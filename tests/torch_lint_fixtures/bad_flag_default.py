"""KNOWN-BAD: a shared runtime flag registered through ONE helper but
resolving to different dataclass defaults per trainer config — the shared
surface must behave identically on every stage."""

import argparse
import dataclasses


@dataclasses.dataclass
class AConfig:
    telemetry: str = "async"


@dataclasses.dataclass
class BConfig:
    telemetry: str = "sync"


def _add_shared(p, d):
    p.add_argument("--telemetry", type=str, default=d.telemetry)


def a_parser():
    d = AConfig()
    p = argparse.ArgumentParser()
    _add_shared(p, d)
    return p


def b_parser():
    d = BConfig()
    p = argparse.ArgumentParser()
    _add_shared(p, d)
    return p
