"""KNOWN-BAD (with bad_metric_keys_copy.py): the second definition of the
same registry name — the multi-source half of the fixture pair."""

FIXTURE_DUP_METRIC_KEYS = ("loss", "top1")
