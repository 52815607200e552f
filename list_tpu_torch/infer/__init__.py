"""The test-split sweep of the port (``pipeline.test_all``)."""
