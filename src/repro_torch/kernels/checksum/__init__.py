"""checksum kernel family: the ChunkSum-32 payload checksum."""
