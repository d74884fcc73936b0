"""The benchmark's yardstick of work: operations and bytes counted from the
algorithm at a call's shapes (never from a kernel), and the card's
published peaks (`peaks.json`)."""
