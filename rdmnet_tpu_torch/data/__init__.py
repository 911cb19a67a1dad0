"""Host-side data: procedural scans, the datasets of the four layouts, the
pair loader, capacity bucketing and padding."""
