"""Tile math for the port: f64 Web-Mercator projection and Morton codes."""
