"""Multi-stream decode: N streams in lockstep rounds on one device
(`batch.BatchDecoder`)."""
