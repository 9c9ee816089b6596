"""KNOWN-BAD: a hardcoded artifact schema in a dict literal while the
module pins schemas in constants. The writer and the ratchet gate must
reference ONE definition (the scripts/perf_ledger.py CHECK_SCHEMA fix)."""

SCHEMA = "fixture_artifact/v1"


def build_output(records):
    return {
        "schema": "fixture_artifact/v1",  # BUG: bypasses the SCHEMA pin
        "records": records,
    }
