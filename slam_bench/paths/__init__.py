"""Camera path kinds, one module each, found by the name a traffic file
gives: `eye_target(i, params)` returns the eye and the look-at target of
frame i."""
