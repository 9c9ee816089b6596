"""KNOWN-BAD: one shared flag, two argparse types. The trainers parse the
same CLI surface; an int/float drift silently changes values on one stage
only (the class the hand-synced copies invited)."""

import argparse


def a_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--print_freq", type=int, default=10)
    return p


def b_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--print_freq", type=float, default=10)
    return p
