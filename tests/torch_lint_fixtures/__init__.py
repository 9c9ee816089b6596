"""Known-bad sources for the port's invariant linter (never imported)."""
