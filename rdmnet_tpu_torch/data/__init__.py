"""Host-side data: procedural scans and capacity bucketing."""
