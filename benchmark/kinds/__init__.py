"""The drivers, one a kind of traffic; a workload file names its kind."""
