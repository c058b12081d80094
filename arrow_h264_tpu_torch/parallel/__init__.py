"""Multi-stream decode: N streams in lockstep rounds (`batch.BatchDecoder`),
on one device or split over several (`sharding`)."""
