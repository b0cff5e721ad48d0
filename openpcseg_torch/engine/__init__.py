"""SegTask: the eval step."""
