"""Host-side data for the port: QA arrays, the feature store, batches."""
