"""Data of the port: ``pipeline`` (the reference's counter-based synthetic
token stream, bit for bit)."""
