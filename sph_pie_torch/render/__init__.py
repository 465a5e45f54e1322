"""On-device splat renderer and a grayscale PNG encoder."""
