"""Host-side data: procedural scans, capacity bucketing and padding, the
demo-pair dataset."""
