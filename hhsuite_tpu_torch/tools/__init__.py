"""Database-build tooling."""
