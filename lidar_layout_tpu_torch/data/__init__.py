"""Range-image data: synthetic scenes and the scan reader."""
