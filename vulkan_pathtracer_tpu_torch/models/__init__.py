"""Scene model: glTF ingest and the flat device-scene bake."""
