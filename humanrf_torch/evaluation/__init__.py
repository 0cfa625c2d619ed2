"""Quality metrics and offline evaluation."""
