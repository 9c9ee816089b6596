"""KNOWN-BAD: a ring-column registry tuple that is neither sorted nor
unique. The ring column order is sorted(keys) on writer AND reader
(train/supcon_step.metric_keys), so the declaration must read in column
order and a duplicate would silently collapse two columns into one."""

FIXTURE_METRIC_KEYS = ("top1", "loss", "top1")
