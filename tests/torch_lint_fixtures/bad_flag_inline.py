"""KNOWN-BAD: a shared RUNTIME flag hand-registered inline in two parsers
instead of through the shared registry helper (the hand-synced config.py
shape the flag-consistency rule exists to forbid)."""

import argparse


def a_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--telemetry", type=str, default="async")
    return p


def b_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--telemetry", type=str, default="async")
    return p
