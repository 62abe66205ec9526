"""Study data types."""
