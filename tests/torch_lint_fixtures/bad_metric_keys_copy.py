"""KNOWN-BAD (with bad_metric_keys_dup.py): the same registry name
literally re-defined in a second module — readers must IMPORT the one
source, or the writer/reader column derivations drift."""

FIXTURE_DUP_METRIC_KEYS = ("loss", "top1")
