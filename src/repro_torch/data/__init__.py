# The synthetic LM data pipeline of the port (SyntheticLM, Prefetcher).
